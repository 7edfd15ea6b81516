"""Simulation configuration: the port's own copy of the `SimConfig` schema.

Counterpart of `parallelnbody_tpu/config.py`. The fields, defaults and
`__post_init__` checks are the same, so every `examples/*.json` loads in
both packages (tests/test_torch_config.py pins the equality). The port keeps
its own copy because importing `parallelnbody_tpu.config` runs
`parallelnbody_tpu/__init__.py`, which imports JAX.

Fields that only steer the JAX package (Pallas tiles, donation, the XLA
compile cache) are kept so that the configs stay interchangeable; this
package does not read them. mesh_shape is the rank count of the
multi-device paths (parallel/).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

FORCE_METHODS = ("direct", "direct_pallas", "barnes_hut", "auto")
INTEGRATORS = ("leapfrog", "dkd", "euler_semi_implicit", "euler", "yoshida4", "rk4")
IC_KINDS = (
    "plummer",
    "hernquist",
    "uniform_cube",
    "uniform_sphere",
    "cold_sphere",
    "disk",
    "galaxy_collision",
    "reference_slab",
    "two_body",
    "king",
    "nfw",
)


def _device_type(device) -> str:
    """'cuda', 'cpu', ... of a torch.device or its name; None is the CPU."""
    if device is None:
        return "cpu"
    return getattr(device, "type", str(device).split(":")[0])


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of one simulation (frozen, hashable)."""

    # --- problem size / physics ---
    n: int = 4096
    dt: float = 0.01
    g: float = 1.0                 # gravitational constant
    softening: float = 1.0e-2      # Plummer softening length eps
    theta: float = 0.5             # Barnes-Hut MAC opening angle

    # --- algorithms ---
    force: str = "auto"            # direct | direct_pallas | barnes_hut | auto
    integrator: str = "leapfrog"   # see INTEGRATORS
    dtype: str = "float32"
    track_potential: bool = True   # False: the hot step skips the potential;
                                   # diagnostics recompute it on demand

    # --- initial conditions ---
    ic: str = "plummer"
    ic_size: float = 1.0           # characteristic length
    seed: int = 0
    virialize: bool = False        # rescale IC speeds so 2K = -W at t=0

    # --- Barnes-Hut parameters ---
    bh_leaf_size: int = 0          # particles per leaf; 0 = auto
    bh_near_budget: int = 0        # near source leaves per target leaf;
                                   # 0 = calibrated from the t=0 geometry
                                   # (api.calibrate_budgets)
    bh_far_budget: int = 0         # far octet entries per target leaf;
                                   # 0 = calibrated, as above
    bh_curve: str = "hilbert"      # hilbert | morton sort order
    bh_distributed: bool = False   # multi-device Barnes-Hut: distributed
                                   # sort (parallel/distributed.py) instead
                                   # of the replicated tree
    bh_multipole: int = 2          # 1 = monopole, 2 = + traceless quadrupole
    bh_max_levels: int = 12
    bh_refine: str = "auto"        # dense | staged | auto
    bh_cand_budget: int = 0        # staged candidate budgets (level 1,
    bh_cand2_budget: int = 0       # level 2); 0 = calibrated
    bh_far_mode: str = "auto"      # octet | gather | auto (= octet)
    bh_sections: int = 0           # target-leaf windows; 0 = auto
    bh_pair_slack: float = 2.0     # distributed Barnes-Hut: exchange and
    bh_own_slack: float = 0.25     # owned capacity slack
    bh_comm: str = "ring"          # its near field: ring | let
    bh_rebuild_every: int = 8      # rebuild the tree geometry every k steps
                                   # inside fused runs (api._make_run_reuse);
                                   # 1 = rebuild every step
    bh_import_budget: int = 0      # LET imports per rank pair; 0 = a full
                                   # neighbour width

    donate_state: bool = False     # JAX buffer donation; the port updates
                                   # nothing in place and ignores it

    # --- Pallas kernel tiling (JAX package only) ---
    tile_i: int = 256
    tile_j: int = 2048

    # --- parallelism: () one device, (P,) or (ICI, DCN) ranks ---
    mesh_shape: tuple = ()
    mesh_axes: tuple = ("ring",)

    # --- run / io ---
    compile_cache_dir: str = ""    # XLA compile cache (JAX package only)
    steps: int = 100
    snapshot_every: int = 0
    snapshot_dir: str = "snapshots"
    log_every: int = 10
    checkpoint_every: int = 0
    checkpoint_dir: str = "checkpoints"

    def __post_init__(self):
        if self.force not in FORCE_METHODS:
            raise ValueError(f"force must be one of {FORCE_METHODS}, got {self.force!r}")
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {INTEGRATORS}, got {self.integrator!r}"
            )
        if self.ic not in IC_KINDS:
            raise ValueError(f"ic must be one of {IC_KINDS}, got {self.ic!r}")
        if self.bh_refine not in ("auto", "dense", "staged"):
            raise ValueError(
                f"bh_refine must be auto|dense|staged, "
                f"got {self.bh_refine!r}")
        if self.bh_far_mode not in ("auto", "octet", "gather"):
            raise ValueError(
                f"bh_far_mode must be auto|octet|gather, "
                f"got {self.bh_far_mode!r}")
        if self.bh_comm not in ("ring", "let"):
            raise ValueError(
                f"bh_comm must be ring|let, got {self.bh_comm!r}")
        if self.bh_import_budget < 0:
            raise ValueError(
                f"bh_import_budget must be >= 0 (0 = auto), "
                f"got {self.bh_import_budget}")
        if self.bh_pair_slack <= 0:
            raise ValueError(
                f"bh_pair_slack must be > 0 (it scales the distributed "
                f"exchange capacity), got {self.bh_pair_slack}")
        if self.bh_own_slack < 0:
            raise ValueError(
                f"bh_own_slack must be >= 0, got {self.bh_own_slack}")
        if self.bh_cand_budget < 0 or self.bh_cand2_budget < 0:
            raise ValueError(
                f"bh_cand_budget/bh_cand2_budget must be >= 0 (0 = auto), "
                f"got {self.bh_cand_budget}/{self.bh_cand2_budget}")
        if self.bh_rebuild_every < 1:
            raise ValueError(
                f"bh_rebuild_every must be >= 1 (1 = rebuild every step), "
                f"got {self.bh_rebuild_every}")
        if self.bh_sections < 0:
            raise ValueError(
                f"bh_sections must be >= 0 (0 = auto), "
                f"got {self.bh_sections}")
        if self.n <= 0:
            raise ValueError("n must be positive")
        if self.dt <= 0:
            raise ValueError(
                "dt must be positive (the reference pauses on PhDeltaTime <= 0, "
                "OctreeSearch.cpp:25; pausing is a host-loop concern here)"
            )
        # normalize tuples (JSON round-trips lists)
        object.__setattr__(self, "mesh_shape", tuple(self.mesh_shape))
        object.__setattr__(self, "mesh_axes", tuple(self.mesh_axes))

    # ------------------------------------------------------------------ utils
    def replace(self, **kw) -> "SimConfig":
        """This config with the fields kw set. A budget set here is the
        caller's own: it leaves `calibrated_budgets`."""
        out = dataclasses.replace(self, **kw)
        kept = self.calibrated_budgets - frozenset(kw)
        if kept:
            object.__setattr__(out, "_calibrated", kept)
        return out

    @property
    def calibrated_budgets(self) -> frozenset:
        """The list-budget fields whose values budget calibration chose
        (api.calibrate_budgets), not the caller: the ones a clipped list
        build may grow (ops/bh.py ListHeal). No dataclass field, so that
        the schema stays the JAX package's; equality, hashing and to_json
        leave it out, so a checkpoint stores the budgets as set."""
        return self.__dict__.get("_calibrated", frozenset())

    def calibrated(self, **budgets) -> "SimConfig":
        """This config with the list budgets `budgets` set by calibration
        (named in calibrated_budgets beside the ones already there)."""
        out = dataclasses.replace(self, **budgets)
        object.__setattr__(out, "_calibrated",
                           self.calibrated_budgets | frozenset(budgets))
        return out

    # Barnes-Hut / all-pairs crossover N, by device. On the CPU the JAX
    # package's value, so that CPU runs resolve as it does. On a CUDA
    # device the card's own: ms/step per step of K3 (force="direct_pallas")
    # against Barnes-Hut, Plummer, theta 0.72 without the potential
    # (chip_smoke.py phase_crossover, the median of 3 means of 5 step(1);
    # NVIDIA H100 80GB HBM3, 700.00 W; the rows of every run in PERF.md):
    #   N = 131072: K3  8.4-9.1,  Barnes-Hut 13.4-24.2 (six runs)
    #   N = 163840: K3 14.0-14.8, Barnes-Hut 14.2-24.7 (seven runs)
    #   N = 196608: K3 19.1-19.7, Barnes-Hut 17.9-24.1 (five runs)
    # Per-step Barnes-Hut is host-bound at these N and moves from one
    # process to the next whatever N, while K3 (device-bound) moves 2-5%.
    # So K3 up to 163840 and Barnes-Hut from 196608, where either pick
    # stays within 1.5x of the other path over the whole host spread (with
    # Barnes-Hut from 163840, two runs on a slow host made it 1.57x and
    # 1.69x slower than K3 there).
    AUTO_BH_CROSSOVER = 32768
    AUTO_BH_CROSSOVER_CUDA = 196608

    # force="auto" picks the all-pairs kernel K3 on a CUDA device from this
    # N up (the JAX package's floor). Below it both K3 and the plain direct
    # sum are launch-bound on the card, 0.2-0.5 ms a step with no steady
    # winner (tools/auto_rules.py floor, PERF.md).
    AUTO_ALLPAIRS_MIN_N = 512

    def bh_crossover(self, device=None) -> int:
        """AUTO_BH_CROSSOVER for `device` (a torch.device or its name; None
        means the CPU)."""
        return (self.AUTO_BH_CROSSOVER_CUDA if _device_type(device) == "cuda"
                else self.AUTO_BH_CROSSOVER)

    # The largest N at which bh_leaf_size = 0 resolves to 128 (256 above),
    # by device. On the CPU the JAX package's 2^19, so that CPU runs build
    # the trees it builds. On a CUDA device the card's own: ms/step per step
    # / at rebuild 8 (step(16)) of leaf 128 against 256 on the shipped
    # Plummer config (examples/barneshut_1m_reuse.json) at each N, every
    # run from one t = 0 state at budgets that clip nothing, two runs of
    # each in the order 128, 256, 256, 128 (tools/auto_rules.py leaf;
    # NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has an earlier call's rows):
    #   N     leaf 128 per step / rebuild 8    leaf 256 per step / rebuild 8
    #   2^20   25.76, 23.86 / 9.65, 9.70        30.60, 25.62 / 16.13, 15.93
    #   2^21   43.91, 44.30 / 17.99, 18.05      44.93, 45.47 / 27.16, 27.31
    #   2^22   73.23, 70.69 / 35.19, 35.88      75.43, 77.61 / 52.08, 52.30
    #   2^23  141.35, 141.39 / 71.73, 71.80    142.99, 143.00 / 104.29, 104.51
    # rms force error 1.01-1.11e-3 at 128 (0.88-1.10e-3 at 256), overflow 0;
    # 2^23 at 128 is 65536 leaves, unsectioned. Per step the two sit within
    # a few per cent (host and geometry); at rebuild 8 leaf 128 halves
    # K1's pair work and runs 31-40% faster. So 128 up to the largest N
    # measured, 256 above it.
    AUTO_LEAF128_MAX_N = 1 << 19
    AUTO_LEAF128_MAX_N_CUDA = 1 << 23

    def resolve_bh_leaf_size(self, device=None) -> int:
        """bh_leaf_size with 0 = auto resolved for `device` (a torch.device
        or its name; None means the CPU): 128 up to the device's
        AUTO_LEAF128_MAX_N, 256 above. Entry points that own a device
        replace the auto with this value once (with_resolved_leaf), so
        that every later call reads a concrete leaf size."""
        if self.bh_leaf_size:
            return self.bh_leaf_size
        top = (self.AUTO_LEAF128_MAX_N_CUDA
               if _device_type(device) == "cuda" else self.AUTO_LEAF128_MAX_N)
        return 128 if self.n <= top else 256

    def with_resolved_leaf(self, device) -> "SimConfig":
        """This config for a run on `device`: on a CUDA device,
        bh_leaf_size = 0 (auto) replaced by the card's value
        (resolve_bh_leaf_size(device)), so that every later
        resolve_bh_leaf_size() / resolve_bh_refine(), the plan's and the
        evaluation's alike, reads the leaf the run was built for, and a
        checkpoint stores it. Elsewhere the config as it is: 0 resolves to
        the CPU's rule (the JAX package's) wherever it is read. The entry
        points that own a device call it once (api.calibrate_budgets, so
        prepare_simulation and Simulation; make_accel_fn, make_run; the CLI
        before it spawns ranks; parallel/'s entry points on the group's
        device)."""
        if self.bh_leaf_size or _device_type(device) != "cuda":
            return self
        return self.replace(bh_leaf_size=self.resolve_bh_leaf_size(device))

    # Static fallbacks for bh_near_budget / bh_far_budget = 0 where no state
    # is at hand to calibrate against (api.calibrate_budgets is the real
    # auto). Same values as the JAX package.
    FALLBACK_NEAR_BUDGET = 3584
    FALLBACK_FAR_BUDGET = 2816

    def resolve_bh_near_budget(self) -> int:
        """bh_near_budget with 0 = auto resolved to the static fallback.
        Entry points that own a state first replace the config through
        api.calibrate_budgets."""
        return self.bh_near_budget or self.FALLBACK_NEAR_BUDGET

    def resolve_bh_far_budget(self) -> int:
        return self.bh_far_budget or self.FALLBACK_FAR_BUDGET

    def resolve_bh_refine(self, device=None) -> str:
        """bh_refine='auto' resolved: the dense leaf plane below 8192 leaves
        (counted as plan_tree pads them, at the leaf size resolved for
        `device`), staged refinement from 8192 up."""
        if self.bh_refine != "auto":
            return self.bh_refine
        from parallelnbody_tpu_torch.ops.bh import plan_tree

        n_leaves, _, _ = plan_tree(self.n,
                                   self.resolve_bh_leaf_size(device))
        return "staged" if n_leaves >= 8192 else "dense"

    def resolve_force(self, device=None) -> str:
        """force='auto' resolved for the device the run uses (a
        torch.device or its name; None means the CPU): Barnes-Hut from the
        device's crossover (bh_crossover) up; below it the all-pairs kernel
        on a CUDA device from AUTO_ALLPAIRS_MIN_N (kernel K3,
        ops/direct_kernels.py), as the JAX package picks its all-pairs
        kernel on a TPU, and the plain direct sum elsewhere."""
        if self.force != "auto":
            return self.force
        if self.n >= self.bh_crossover(device):
            return "barnes_hut"
        if _device_type(device) == "cuda" and \
                self.n >= self.AUTO_ALLPAIRS_MIN_N:
            return "direct_pallas"
        return "direct"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SimConfig":
        data: dict[str, Any] = json.loads(text)
        return cls(**data)

    @property
    def n_devices(self) -> int:
        out = 1
        for s in self.mesh_shape:
            out *= s
        return out


def reference_compat_config(n: int = 1024, size: float = 200.0) -> SimConfig:
    """Config reproducing the reference's hardcoded semantics.

    Force law a += G*M/d^3 * (CoM - x) with G=1e4 and no softening
    (OctreeSearch.h:104,102), theta=1.0 (OctreeSearch.cpp:85), semi-implicit
    Euler with dt=0.01 (OctreeSearch.cpp:8,28-31), slab ICs with a central body
    (OctreeSearch.cpp:58-72).
    """
    return SimConfig(
        n=n,
        dt=0.01,
        g=1.0e4,
        softening=0.0,
        theta=1.0,
        integrator="euler_semi_implicit",
        ic="reference_slab",
        ic_size=size,
        force="direct",
    )
