"""The distributed Barnes-Hut path once at a production shape: the port of
scripts/dist_production_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.dist_production_probe
        [--n 262144] [--steps 16] [--devices 8] [--k 8] [--leaf 128]
        [--near 1024] [--far 2048] [--device cuda] [--out FILE]

The script's shape: N = 262144 Plummer, P = 8 ranks, staged refinement
forced at leaf 128, octet far field (auto), `bh_rebuild_every` = 8, the
near budget 1024 and far budget 2048 (set: the distributed path does not
calibrate them), theta 0.72, quadrupoles, no potential in the hot step,
f32. From one start state (the config's ICs and `sharded_init_accel`'s t =
0 forces) it runs `make_distributed_run` for the ring and the LET near
field and reports for each: the overflow (must be 0), the sampled rms
force error of the final state (`rms_force_error_sample`, k = 4096, on the
run's device), the host wall seconds of the run, the steps done, and rank
0's kernel launches and collectives (`parallel/mesh.py LAST_RANK_STATS`).
Then the ring-against-LET max |delta pos|, and the per-step migrant series
of `make_distributed_run(..., debug_exchange=True)` over min(steps, 8)
steps (step 0 the entry exchange, ~(P - 1) / P of N; the rest the
boundary crossings of each step's repartition).

On a machine with one card the ranks share it through gloo with host
staging (`mesh.backend_for`): the walls are evidence that the program is
right at this shape, not of its scaling, and the record says so. Any rank
that fails raises `RankError`; nothing here catches it. `--device cpu`
runs the ranks on the CPU (the tests, at a small N).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.parallel import RankPool, mesh, tasks
from parallelnbody_tpu_torch.parallel.distributed import _dist_reuse_eligible
from parallelnbody_tpu_torch.state import state_from_numpy, torch_dtype
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

FIELDS = ("pos", "vel", "mass", "acc", "pot")
WALLS = ("ranks share one card through gloo with host staging: the walls "
         "show the program right at this shape, not its scaling")


def whole(outs):
    """The full state (numpy) from every rank's tasks.sharded output."""
    full = {k: np.concatenate([o["state"][k] for o in outs])
            for k in FIELDS}
    full.update(time=outs[0]["state"]["time"],
                step=outs[0]["state"]["step"])
    return full


def start_arrays(pool, cfg, arrays=None):
    """The run's start: `arrays` (the full state as numpy, or None for the
    config's own ICs) with sharded_init_accel's t = 0 forces (and
    virialization) on the ranks."""
    return whole(pool.run(tasks.sharded, cfg.to_json(), arrays, "init"))


def rank_stats():
    """Rank 0's kernel launches and collectives of the last pool run."""
    st = mesh.LAST_RANK_STATS[0]
    return {"launches_rank0": {k: v for k, v in st["launches"].items() if v},
            "collectives_rank0": st["collectives"],
            "staged_bytes_rank0": st["staged_bytes"],
            "backend": st["backend"]}


def make_cfg(n, leaf, near, far, k):
    """The script's configuration."""
    return SimConfig(n=n, ic="plummer", dt=1e-4, softening=0.01,
                     theta=0.72, force="barnes_hut", integrator="leapfrog",
                     bh_leaf_size=leaf, bh_refine="staged",
                     bh_near_budget=near, bh_far_budget=far,
                     bh_multipole=2, bh_distributed=True,
                     bh_rebuild_every=k, track_potential=False,
                     dtype="float32")


def probe(pool, cfg, n_steps, device, arrays=None, out=None):
    """The three runs on pool from one start state; emits a line for each
    comm and the report; returns the report."""
    if not _dist_reuse_eligible(cfg, n_steps):
        raise ValueError("the configuration is not eligible for the "
                         "distributed rebuild interval")
    start = start_arrays(pool, cfg, arrays)
    report = {"tool": "dist_production_probe",
              "card": measure.card_of(device), "n": cfg.n,
              "devices": pool.world_size, "steps": n_steps,
              "k": cfg.bh_rebuild_every, "leaf": cfg.bh_leaf_size,
              "refine": cfg.bh_refine, "near_budget": cfg.bh_near_budget,
              "far_budget": cfg.bh_far_budget, "walls": WALLS}
    finals = {}
    for comm in ("ring", "let"):
        c = cfg.replace(bh_comm=comm)
        t0 = time.perf_counter()
        outs = pool.run(tasks.sharded, c.to_json(), start, "distributed",
                        n_steps)
        wall = time.perf_counter() - t0
        final = finals[comm] = whole(outs)
        st = state_from_numpy(final, device, torch_dtype(c.dtype))
        report[comm] = {
            "overflow": outs[0]["overflow"], "wall_s": wall,
            "rms_force_error": rms_force_error_sample(
                st.pos, st.mass, st.acc, g=c.g, softening=c.softening),
            "steps_done": int(final["step"]), **rank_stats()}
        measure.emit({"tool": "dist_production_probe", "comm": comm,
                      **report[comm]}, out)
    report["ring_vs_let_max_pos_diff"] = float(np.max(np.abs(
        finals["ring"]["pos"] - finals["let"]["pos"])))
    # debug_exchange runs the per-step program.
    t0 = time.perf_counter()
    outs = pool.run(tasks.sharded, cfg.to_json(), start, "distributed",
                    min(n_steps, 8), True)
    migs = np.asarray(outs[0]["migrants"], dtype=np.int64)
    report["per_step"] = {
        "overflow": outs[0]["overflow"],
        "wall_s": time.perf_counter() - t0,
        "migrants_entry": int(migs[0]),
        "migrants_series": [int(x) for x in migs[1:]],
        "migrants_steady_frac_of_n": (float(migs[1:].mean() / cfg.n)
                                      if len(migs) > 1 else None),
        **rank_stats()}
    measure.emit(report, out)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--leaf", type=int, default=128)
    ap.add_argument("--near", type=int, default=1024)
    ap.add_argument("--far", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    cfg = make_cfg(args.n, args.leaf, args.near, args.far, args.k)
    with RankPool(args.devices, dev) as pool:
        return probe(pool, cfg, args.steps, dev, out=args.out)


if __name__ == "__main__":
    main()
