"""Simulation API. Counterpart of `parallelnbody_tpu/api.py`.

    init_simulation(cfg)        ICs (+ t=0 forces)
    prepare_simulation(cfg)     ICs + budget calibration + t=0 forces
    make_step(cfg)              one integration step: force + integrate
    make_run(cfg, k)            k steps, with the tree-rebuild interval
    Simulation(cfg, device)     host shell owning cfg + state

JAX's jit and lax.scan become plain Python loops over torch operations on
the run's device. On a CUDA device the force evaluations run the
hand-written kernels (ops/bh_kernels.py for Barnes-Hut, ops/direct_kernels.py
for force="direct_pallas"); nothing falls back to the CPU.

The host shell's spans (utils/profiling.span): `api.step` (one make_step
call), `api.run` (one make_run call), `api.block` (one rebuild block of the
rebuild-interval run), `integrator` (an integrator call, around its force
evaluations, each a `force` span), and in set-up `api.prepare` around
`api.calibrate` and `api.initial_forces`.
"""

from __future__ import annotations

from typing import Callable

import torch

from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.models import get_ic
from parallelnbody_tpu_torch.ops import energy as energy_ops
from parallelnbody_tpu_torch.ops.integrators import get_integrator
from parallelnbody_tpu_torch.state import (SimState, make_state, resolve_device,
                                           torch_dtype)
from parallelnbody_tpu_torch.utils.profiling import span


def _zero_count(device):
    """A zero of the list-overflow counter's dtype (ops/bh.py's int64)."""
    return torch.zeros((), dtype=torch.int64, device=device)


# --------------------------------------------------------------------- forces
def make_accel_fn(cfg: SimConfig, mass: torch.Tensor,
                  overflow_cell: list | None = None, heal=None) -> Callable:
    """Return accel_fn(pos) -> (acc, pot) for the configured force method.

    overflow_cell: optional one-element list accumulating the Barnes-Hut
    list-budget overflow counter of every evaluation. The direct method has
    no budgets and leaves it unchanged. The auto leaf size resolves on
    mass's device (SimConfig.with_resolved_leaf). heal: the caller's
    Barnes-Hut ListHeal (ops/bh.py; make_step's, or Simulation's shared one)."""
    cfg = cfg.with_resolved_leaf(mass.device)
    method = cfg.resolve_force(mass.device)
    if method == "direct":
        from parallelnbody_tpu_torch.ops.direct import direct_accel

        n = mass.shape[0]
        # Bound memory: stream row tiles (largest power-of-two divisor of N
        # up to 1024; N <= 2048 runs unblocked).
        tile = 0
        if n > 2048:
            tile = 1
            for t in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2):
                if n % t == 0:
                    tile = t
                    break

        def accel_fn(pos):
            with span("force"):
                return direct_accel(pos, mass, g=cfg.g,
                                    softening=cfg.softening, tile=tile)

        return accel_fn
    if method == "direct_pallas":
        from parallelnbody_tpu_torch.ops.direct_kernels import \
            make_allpairs_accel

        return make_allpairs_accel(cfg, mass)
    if method == "barnes_hut":
        from parallelnbody_tpu_torch.ops.bh import make_bh_accel

        return make_bh_accel(cfg, mass, overflow_cell=overflow_cell,
                             heal=heal)
    raise ValueError(f"unknown force method {method!r}")


# ----------------------------------------------------------------------- init
def virialize_state(state: SimState) -> SimState:
    """Rescale speeds so 2K = -W using state.pot."""
    ke = 0.5 * torch.sum(state.mass * torch.sum(state.vel * state.vel, dim=-1))
    w = 0.5 * torch.sum(state.mass * state.pot)
    scale = torch.sqrt(torch.clamp(-w, min=1e-30)
                       / torch.clamp(2.0 * ke, min=1e-30))
    return state._replace(vel=state.vel * scale)


def init_simulation(cfg: SimConfig, device="cuda",
                    compute_forces: bool = True) -> SimState:
    """Generate ICs on the CPU from cfg.seed, move them to `device` (the
    card unless the caller names another), and (compute_forces=True)
    evaluate the t=0 forces so leapfrog can start."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    pos, vel, mass = get_ic(cfg.ic)(gen, cfg)
    state = make_state(pos, vel, mass, seed=cfg.seed, device=device,
                       dtype=torch_dtype(cfg.dtype))
    if not compute_forces:
        return state
    return _fill_initial_forces(cfg, state)


def _fill_initial_forces(cfg: SimConfig, state: SimState) -> SimState:
    """t=0 force evaluation (+ virialization) for a fresh state."""
    accel_cfg = cfg
    if cfg.virialize and not cfg.track_potential:
        # virialize_state needs the real potential: with track_potential
        # off the force paths return pot = 0, so turn it on for this one
        # evaluation (make_step keeps the run's setting).
        accel_cfg = cfg.replace(track_potential=True)
    acc, pot = make_accel_fn(accel_cfg, state.mass)(state.pos)
    state = state._replace(acc=acc, pot=pot)
    if cfg.virialize:
        state = virialize_state(state)
    return state


def calibrate_budgets(cfg: SimConfig, state: SimState,
                      headroom: float = 1.25,
                      n_ranks: int | None = None) -> SimConfig:
    """Resolve bh_*_budget = 0 (auto) fields by measuring this state's exact
    per-target interaction-list requirements (ops/bh.py
    measure_budget_requirements) and adding `headroom` for evolution: the
    near and far list budgets, and with staged refinement the level-2 and
    level-1 candidate budgets (bh_cand2_budget, bh_cand_budget).
    Explicitly-set (nonzero) budgets are kept.

    n_ranks: stating the distributed rank count also calibrates the LET
    import budget (bh_distributed, bh_comm="let", bh_import_budget=0) from
    ops/bh.py measure_import_requirement, scaled from the proxy's leaves a
    rank to the run's owned-capacity leaf count (parallel/distributed.py
    _plan_cfg), as the JAX package does. Left unset, the run keeps the
    always overflow-free full neighbour width.

    Returns cfg with concrete budgets (unchanged for non-Barnes-Hut
    forces), the list budgets it chose named in cfg.calibrated_budgets
    (the ones a clipped list build may grow, ops/bh.py ListHeal), and on a
    CUDA device the auto leaf size resolved for it
    (SimConfig.with_resolved_leaf), the leaf the budgets were measured
    at."""
    cfg = cfg.with_resolved_leaf(state.pos.device)
    if cfg.resolve_force(state.pos.device) != "barnes_hut":
        return cfg
    from parallelnbody_tpu_torch.ops.bh import (
        BUDGET_FIELDS, BUDGET_LANES, BHSetup, measure_budget_requirements,
        measure_import_requirement, pad_budget)

    # The candidate budgets only where the lists are staged.
    staged = BHSetup.of(cfg, state.pos.shape[0]).refine == "staged"
    want = [k for k, f in BUDGET_FIELDS.items() if getattr(cfg, f) == 0
            and (staged or k in ("near", "far"))]
    want_imp = (n_ranks is not None and n_ranks > 1 and cfg.bh_distributed
                and cfg.bh_comm == "let" and cfg.bh_import_budget == 0)
    if not (want or want_imp):
        return cfg

    kw = {}
    if want:
        req = measure_budget_requirements(state.pos, state.mass, cfg)
        # Relative headroom AND one full lane of absolute slack, rounded up
        # to a multiple (the JAX package's rule); near at most every leaf.
        kw = {BUDGET_FIELDS[k]: pad_budget(req[f"{k}_max"], BUDGET_LANES[k],
                                           headroom) for k in want}
        if "near" in want:
            kw["bh_near_budget"] = min(kw["bh_near_budget"], req["n_leaves"])
    if want_imp:
        from parallelnbody_tpu_torch.parallel.distributed import _plan_cfg

        imp = measure_import_requirement(state.pos, state.mass,
                                         cfg.replace(**kw), n_ranks)
        n_local = -(-cfg.n // n_ranks)
        _, _, n_leaf_loc = _plan_cfg(cfg, n_local, n_ranks,
                                     cfg.resolve_bh_leaf_size())
        scaled = -(-imp["import_max"] * n_leaf_loc) // imp["n_leaf_loc_proxy"]
        return cfg.calibrated(**kw).replace(
            bh_import_budget=min(pad_budget(scaled, 8, headroom), n_leaf_loc))
    return cfg.calibrated(**kw)


def prepare_simulation(cfg: SimConfig, device="cuda",
                       state: SimState | None = None
                       ) -> tuple[SimConfig, SimState]:
    """ICs + budget auto-calibration + t=0 forces, in that order. Returns
    (calibrated cfg, initialized state); make_step/make_run are built from
    the returned cfg, which holds the leaf size resolved for `device`
    (calibrate_budgets resolves it). `state`, where given, holds the
    initial conditions (on `device`) in place of the config's own.

    On a CUDA device the auto budgets also cover the state one step on: a
    trial step from the t = 0 state is measured as the t = 0 state is, and
    each auto budget takes the larger of the two. The near lists of the
    first step can outgrow the initial conditions' (SimConfig(n=2^20) at
    the card's leaf 128: t = 0 calibrated 512, one step on 896 needed;
    tools/auto_rules.py calib, PERF.md). On the CPU the JAX package's t = 0
    calibration alone."""
    device = resolve_device(device)
    with span("api.prepare"):
        if state is None:
            state = init_simulation(cfg, device, compute_forces=False)
        with span("api.calibrate"):
            cal = calibrate_budgets(cfg, state)
        with span("api.initial_forces"):
            state = _fill_initial_forces(cal, state)
        auto = cal.calibrated_budgets
        if (device.type == "cuda" and auto
                and cfg.resolve_force(device) == "barnes_hut"):
            ahead = make_step(cal)(state)
            with span("api.calibrate"):
                ahead = calibrate_budgets(cfg, ahead)
            cal = cal.calibrated(**{f: max(getattr(cal, f), getattr(ahead, f))
                                    for f in auto})
        return cal, state


# ----------------------------------------------------------------------- step
def _list_heal(cfg: SimConfig):
    """A new ListHeal (ops/bh.py) of the budgets that calibration chose in
    cfg, for the callables that share it; None where it chose none."""
    from parallelnbody_tpu_torch.ops.bh import ListHeal

    return ListHeal.of(cfg)


def make_step(cfg: SimConfig, report_overflow: bool = False,
              heal=None) -> Callable:
    """One integration step: force + integrate.

    report_overflow=True: step(state) -> (state, overflow), overflow the
    int64 Barnes-Hut budget-clip counter summed over this step's force
    evaluations (zero for the direct method).

    Budgets that calibration chose (cfg.calibrated_budgets) grow where an
    evaluation's lists clip them, and the lists are built again before
    any force is taken from them (ops/bh.py ListHeal); the grown budgets
    stay for the later steps. heal: a ListHeal shared with other
    callables (Simulation's); by default the step keeps its own."""
    integrator = get_integrator(cfg.integrator)
    heal = heal or _list_heal(cfg)

    def step(state: SimState):
        with span("api.step"):
            of_cell = [_zero_count(state.pos.device)]
            accel_fn = make_accel_fn(cfg, state.mass, overflow_cell=of_cell,
                                     heal=heal)
            dt = torch.as_tensor(cfg.dt, dtype=state.pos.dtype,
                                 device=state.pos.device)
            with span("integrator"):
                pos, vel, acc, pot = integrator(
                    accel_fn, state.pos, state.vel, state.acc, state.pot, dt)
            out = state._replace(pos=pos, vel=vel, acc=acc, pot=pot,
                                 time=state.time + dt, step=state.step + 1)
            return (out, of_cell[0]) if report_overflow else out

    return step


# Plan/eval cost ratio of the rebuild-block cost model (_reuse_block_size),
# by device type. CPU: the JAX package's value, so that both packages pick
# the same block sizes and tail masks there. CUDA: one block's plan (sort,
# pyramid, traversal, lists, K1's items and K2's order) against one
# frozen-list evaluation on the card (tools/auto_rules.py plan_eval, NVIDIA
# H100 80GB HBM3, 700.00 W, two runs): 7.89-9.25 / 15.35-15.53 ms =
# 0.514-0.596 at N = 1M dense (examples/barneshut_1m_reuse.json),
# 45.63-45.79 / 97.68-98.12 ms = 0.467 at N = 8M staged
# (examples/barneshut_8m.json). The two ratios pick different blocks at
# some run lengths: at 33 steps 0.3 picks 3 and 0.5 picks 7, and on the
# card blocks of 7 run 16.9-17.4 ms/step against 17.7-18.4 at 1M and
# 110.1-111.1 against 113.0-114.2 at 8M (tools/auto_rules.py block, two
# runs).
_REUSE_PLAN_RATIO = {"cpu": 0.3, "cuda": 0.5}


def _plan_ratio(device) -> float:
    return _REUSE_PLAN_RATIO["cuda" if torch.device(device).type == "cuda"
                             else "cpu"]


def _reuse_block_size(k_max: int, n_steps: int,
                      plan_ratio: float = _REUSE_PLAN_RATIO["cpu"]) -> int:
    """Pick the rebuild-block size k <= k_max minimizing total work for a
    run of n_steps: the tail (n_steps % k) is folded into a full k-step
    block as dt=0 masked evals, so the evaluation count is
    ceil(n_steps/k)*k. Cost model: evals + blocks*plan_ratio. Never exceeds
    k_max, so the rebuild cadence is only ever tightened."""
    best, best_cost = 1, float("inf")
    for k in range(1, min(k_max, n_steps) + 1):
        blocks = -(-n_steps // k)
        cost = blocks * k + blocks * plan_ratio
        if cost < best_cost:
            best, best_cost = k, cost
    return best


def _reuse_eligible(cfg: SimConfig, n_steps: int, device="cpu") -> bool:
    """bh_rebuild_every > 1 applies to the Barnes-Hut octet path; gather
    rebuilds every step, as in the JAX package. force="auto" is resolved
    for `device`, the run's, as make_accel_fn resolves it. The JAX
    package also caps it at a row count that works around a fault of its
    TPU runtime; the port has no such cap."""
    if cfg.bh_rebuild_every <= 1 or n_steps <= 1:
        return False
    if cfg.resolve_force(device) != "barnes_hut":
        return False
    from parallelnbody_tpu_torch.ops.bh import BHSetup

    return BHSetup.of(cfg).far_mode == "octet"


def _make_run_reuse(cfg: SimConfig, n_steps: int, report_overflow: bool,
                    device="cpu", heal=None) -> Callable:
    """Run with a tree-rebuild interval (cfg.bh_rebuild_every = k): the
    state is carried in curve-sorted order; each block of k steps pays ONE
    sort + ONE traversal/list build (ops/bh.py rebuild_block), then k
    evaluations that refresh only the multipole pyramid against the frozen
    lists. The original particle order is restored at the end through a
    carried original-index column. The block size follows `device`'s
    plan/eval ratio (_REUSE_PLAN_RATIO). A block whose lists clip a budget
    that calibration chose builds them again at grown budgets, kept for
    the later blocks (ops/bh.py ListHeal; heal as make_step's). On the
    card each block's geometry up to its host read is one CUDA graph,
    kept by the run (ops/bh.py BlockGraph)."""
    from parallelnbody_tpu_torch.ops import bh

    integrator = get_integrator(cfg.integrator)
    n = cfg.n
    setup = bh.BHSetup.of(cfg)
    k = _reuse_block_size(cfg.bh_rebuild_every, n_steps, _plan_ratio(device))
    n_blocks, tail = divmod(n_steps, k)
    heal = heal or _list_heal(cfg)
    graph = bh.BlockGraph() if torch.device(device).type == "cuda" else None

    def block(carry, dt_mask):
        """One rebuild block: sort, tree, lists, then len(dt_mask) steps.
        A tail block of t < k live steps masks the rest with dt = 0, an
        exact no-op for pos/vel/time/step."""
        pos, vel, acc, mass, orig, time, step, of = carry
        (ps, vs, as_, mass_s, orig_s), plan, accel_fn = bh.rebuild_block(
            pos, vel, acc, mass, orig, setup, n, heal, graph)
        dt = torch.as_tensor(cfg.dt, dtype=pos.dtype, device=pos.device)
        # pot is a placeholder until the first inner step overwrites it:
        # every integrator returns pot from its final accel_fn call.
        pots = torch.zeros_like(mass_s)
        for m in dt_mask:
            dt_eff = dt * m
            with span("integrator"):
                ps, vs, as_, pots = integrator(accel_fn, ps, vs, as_, pots,
                                               dt_eff)
            time = time + dt_eff
            step = step + int(m > 0)
        return (ps, vs, as_, mass_s, orig_s, time, step,
                of + plan.overflow), pots

    def run(state: SimState):
        dev = state.pos.device
        n_pad = setup.n_pad
        z3 = state.pos.new_zeros((n_pad - n, 3))
        carry = (
            torch.cat([state.pos, z3], 0),
            torch.cat([state.vel, z3], 0),
            torch.cat([state.acc, z3], 0),
            torch.cat([state.mass, state.mass.new_zeros(n_pad - n)], 0),
            torch.arange(n_pad, dtype=torch.int32, device=dev),
            state.time, state.step, _zero_count(dev),
        )
        masks = [[1.0] * k] * n_blocks
        if tail:
            masks.append([1.0] * tail + [0.0] * (k - tail))
        pot = None
        for row in masks:
            with span("api.block"):
                carry, pot = block(carry, row)
        pos, vel, acc, _, orig, time, step, overflow = carry
        # Exit unsort: orig is a permutation of [0, n_pad), so scattering
        # each row back to orig restores the caller's particle order.
        with span("bh.unsort"):
            inv = torch.empty_like(orig, dtype=torch.int64)
            inv[orig.long()] = torch.arange(n_pad, device=dev)
            inv = inv[:n]
            out = state._replace(pos=pos[inv], vel=vel[inv], acc=acc[inv],
                                 pot=pot[inv], time=time, step=step)
        return (out, overflow) if report_overflow else out

    return run


def make_run(cfg: SimConfig, n_steps: int,
             report_overflow: bool = False, heal=None) -> Callable:
    """n_steps steps in one call.

    report_overflow=True: run(state) -> (state, overflow), overflow summed
    over all steps. heal: as make_step's. cfg.bh_rebuild_every > 1 routes
    eligible Barnes-Hut
    configurations to the tree-rebuild-interval run (_make_run_reuse).
    Which program runs depends on the run's device (force="auto" and the
    plan/eval ratio, the auto leaf size), so it is chosen at the first
    call from the state's device, as make_step resolves its force method
    and leaf size from the state's."""
    built: dict[str, Callable] = {}

    def build(device) -> Callable:
        cfg_d = cfg.with_resolved_leaf(device)
        if _reuse_eligible(cfg_d, n_steps, device):
            return _make_run_reuse(cfg_d, n_steps, report_overflow, device,
                                   heal=heal)
        step = make_step(cfg_d, report_overflow=True, heal=heal)

        def run(state: SimState):
            overflow = _zero_count(state.pos.device)
            for _ in range(n_steps):
                state, of = step(state)
                overflow = overflow + of
            return (state, overflow) if report_overflow else state

        return run

    def run_on_state_device(state: SimState):
        with span("api.run"):
            device = state.pos.device
            if device.type not in built:
                built[device.type] = build(device)
            return built[device.type](state)

    return run_on_state_device


# ----------------------------------------------------------------- host shell
class Simulation:
    """Host-side shell: owns cfg + state on one device and drives steps.

    `overflow` accumulates the Barnes-Hut list-budget clip counter over
    every step taken (a device tensor; 0 means nothing was clipped). Auto
    budgets that a list build clips are grown before any force is taken
    from the lists (ops/bh.py ListHeal), so only budgets the caller set can
    clip. One heal serves step(1), every step(n) and diagnostics(): a
    budget grown in one is grown in all.

    state: initial conditions on `device` in place of the config's own
    (prepare_simulation's state)."""

    def __init__(self, cfg: SimConfig, device="cuda",
                 state: SimState | None = None):
        self.device = resolve_device(device)
        # prepare_simulation calibrates any auto (0) Barnes-Hut budgets
        # against the actual ICs before the first force evaluation; the
        # calibrated cfg is what every step function is built from.
        self.cfg, self.state = prepare_simulation(cfg, self.device, state)
        self._heal = _list_heal(self.cfg)
        self._step = make_step(self.cfg, report_overflow=True,
                               heal=self._heal)
        self._runs: dict[int, Callable] = {}
        self.overflow = _zero_count(self.device)

    def step(self, n: int = 1) -> SimState:
        if n == 1:
            self.state, of = self._step(self.state)
        else:
            if n not in self._runs:
                self._runs[n] = make_run(self.cfg, n, report_overflow=True,
                                         heal=self._heal)
            self.state, of = self._runs[n](self.state)
        self.overflow = self.overflow + of
        return self.state

    def reset(self, seed: int | None = None) -> SimState:
        """Fresh ICs (optionally with a new seed) under the current cfg."""
        if seed is not None:
            self.cfg = self.cfg.replace(seed=seed)
        self.state = init_simulation(self.cfg, self.device)
        return self.state

    def diagnostics(self) -> dict:
        state = self.state
        if not self.cfg.track_potential:
            # Hot steps skipped the potential; recompute it for diagnostics.
            accel_fn = make_accel_fn(self.cfg.replace(track_potential=True),
                                     state.mass, heal=self._heal)
            _, pot = accel_fn(state.pos)
            state = state._replace(pot=pot)
        vals = energy_ops.diagnostics(state)
        return {k: float(v) for k, v in vals.items()}
