"""The persistent distributed run's per-step exchange volume: the port of
scripts/exchange_volume_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.exchange_volume_probe
        [--n 16384] [--steps 120] [--dt 0.004] [--theta 0.9]
        [--own-slack 1.0] [--pair-slack 4.0] [--devices 8]
        [--device cuda] [--out FILE]

The key-sharded run exchanges only the particles that cross a rank
boundary at each step's repartition; after the entry exchange (~(P - 1) /
P of N) a step should move a small fraction. The probe counts them over a
real trajectory on P = 8 ranks (`make_distributed_run(...,
debug_exchange=True)`, the per-step program, from `sharded_init_accel`'s
start) for the script's two cases: a virialized Plummer sphere, in
equilibrium, and the `cold_sphere` collapse, the worst case for key churn.
The script's settings: leaf 64, budgets 1024 / 2048, theta 0.9 (the
migrants follow the trajectory, not the MAC), exchange slacks 1.0 / 4.0
(at probe-size shards the collapse clips the owned capacity at the
defaults).

One JSON line a case: the entry-exchange fraction, the steady mean, p90
(`np.percentile`, as the script) and max of the later steps' fractions,
the steady mean migrants a step, the final time, the overflow and rank
0's kernel launches and collectives (`LAST_RANK_STATS`). A run
with overflow > 0 raises after its line is printed: such a table
measures a broken run. On one card the ranks share it through gloo with
host staging. `--device cpu` runs the ranks on the CPU (the tests).
"""

from __future__ import annotations

import argparse

import numpy as np

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.parallel import RankPool, tasks
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.tools.dist_production_probe import (
    rank_stats, start_arrays)


def cases(n, dt, theta, own_slack, pair_slack):
    """The script's two (name, config) cases."""
    common = dict(n=n, force="barnes_hut", softening=0.01, theta=theta,
                  integrator="leapfrog", bh_leaf_size=64,
                  bh_near_budget=1024, bh_far_budget=2048, dt=dt,
                  bh_own_slack=own_slack, bh_pair_slack=pair_slack,
                  bh_distributed=True)
    return [("plummer (virialized equilibrium)",
             SimConfig(ic="plummer", virialize=True, **common)),
            ("cold_sphere (violent collapse)",
             SimConfig(ic="cold_sphere", **common))]


def run_case(pool, name, cfg, n_steps, device, arrays=None, out=None):
    """One case on pool from `arrays` (the full ICs as numpy; None: the
    config's own); emits and returns its record."""
    start = start_arrays(pool, cfg, arrays)
    outs = pool.run(tasks.sharded, cfg.to_json(), start, "distributed",
                    n_steps, True)
    mig = np.asarray(outs[0]["migrants"], dtype=np.int64)
    frac = mig / cfg.n
    entry, steady = frac[0], frac[1:]
    rec = {"tool": "exchange_volume_probe", "card": measure.card_of(device),
           "case": name, "n": cfg.n, "ranks": pool.world_size,
           "steps": n_steps, "dt": cfg.dt, "overflow": outs[0]["overflow"],
           "migrants": [int(m) for m in mig],
           "entry_exchange_frac": float(entry),
           "steady_mean_frac": float(steady.mean()),
           "steady_p90_frac": float(np.percentile(steady, 90)),
           "steady_max_frac": float(steady.max()),
           "steady_mean_migrants_per_step": float(mig[1:].mean()),
           "final_time": float(outs[0]["state"]["time"]), **rank_stats()}
    measure.emit(rec, out)
    if rec["overflow"]:
        raise AssertionError(f"{name}: overflow {rec['overflow']}, the "
                             "exchange table measures a broken run")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--dt", type=float, default=0.004)
    ap.add_argument("--theta", type=float, default=0.9)
    ap.add_argument("--own-slack", type=float, default=1.0)
    ap.add_argument("--pair-slack", type=float, default=4.0)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    with RankPool(args.devices, dev) as pool:
        return [run_case(pool, name, cfg, args.steps, dev, out=args.out)
                for name, cfg in cases(args.n, args.dt, args.theta,
                                       args.own_slack, args.pair_slack)]


if __name__ == "__main__":
    main()
