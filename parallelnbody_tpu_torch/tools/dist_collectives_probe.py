"""The collective schedule of the distributed Barnes-Hut run, per step
against the rebuild interval: the port of scripts/dist_collectives_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.dist_collectives_probe
        [--n 8192] [--steps 16] [--k 8] [--devices 8] [--comm ring let]
        [--near 256] [--far 512] [--device cuda] [--out FILE]

The script counted collective primitives in the JAX program, walking its
jaxpr with scan bodies weighted by their trip counts. The port runs its
program, so it counts the collectives it runs: `parallel/mesh.py
RingGroup.collectives`, by kind ("all_gather", "all_to_all",
"all_reduce:sum/min/max", "shift" for the ring ppermute), set to empty as
each `RankPool.run` starts and returned in `LAST_RANK_STATS`. At world
size 1 no collective runs and none is counted. A count at run time sees
only the branch a run takes; the script's walk counts every branch of a
`cond`, but no collective of the JAX run sits in one, so the two count the
same program.

The configuration is the script's (Plummer, dt 1e-4, softening 0.01, leaf
32, budgets 256 / 512, distributed, the ICs without t = 0 forces); the
script only traced the program, and on the ranks these budgets clip (each
line prints its overflow); the schedule does not depend on the budgets,
so `--near` / `--far` can run it unclipped with the same counts. Each
comm runs `make_distributed_run` over --steps steps per step and at
`bh_rebuild_every` = --k on --devices ranks (`parallel/tasks.py sharded`).
Every rank must count the same.

The raw totals differ from the JAX package's by design: the port sends
the float and the int columns of an exchange in one all_to_all each, where
JAX sends one a column (13 a repartition, 11 at the exit), the leaf
summary table in one all_gather (JAX: 4, one a field), a ring pass's
particles in one shift (JAX: 2 ppermutes) and the domain bounds in one
max reduction (JAX: pmin and pmax). `ISSUES` is that mapping from both
codes; `structure` inverts it into the structural counts that must
agree: repartitions, tree builds (the summary gather of each evaluation,
and of each block's plan under the rebuild interval), force evaluations,
ring shifts, LET requests and responses, the exit exchange and the
overflow reductions, and it raises where the counts do not recompose
exactly. Each run's line holds the raw counts, their total and per-step
mean, the structural counts, and the total the JAX package would issue for
the same structure; the last line the reductions. On the card the ranks
share the one GPU through gloo with host staging; the counts are the
program's, whatever the devices.
"""

from __future__ import annotations

import argparse

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.parallel import RankPool, mesh, tasks
from parallelnbody_tpu_torch.tools import measure

# The collectives one structural event issues, by code: the JAX package's
# lax primitives (parallelnbody_tpu/parallel/distributed.py, named as a
# jaxpr names them) and the port's RingGroup calls (parallel/
# distributed.py, by counter kind). "tree" is with quadrupoles (JAX
# gathers 3 fields without).
ISSUES = {
    "jax": {
        "repartition": {"pmin": 1, "pmax": 1, "all_gather": 1,
                        "all_to_all": 13, "psum": 1},
        "tree": {"all_gather": 4},
        "ring_shift": {"ppermute": 2},
        "let_request": {"all_to_all": 1},
        "let_response": {"all_to_all": 1},
        "exit": {"all_to_all": 11},
        "overflow_reduction": {"psum": 1},
    },
    "port": {
        "repartition": {"all_reduce:max": 1, "all_gather": 1,
                        "all_to_all": 2},
        "tree": {"all_gather": 1},
        "ring_shift": {"shift": 1},
        "let_request": {"all_to_all": 1},
        "let_response": {"all_to_all": 1},
        "exit": {"all_to_all": 2},
        "overflow_reduction": {"all_reduce:sum": 1},
    },
}
# Structural count -> event of ISSUES it multiplies.
EVENTS = {"repartitions": "repartition", "tree_builds": "tree",
          "ring_shifts": "ring_shift", "let_requests": "let_request",
          "let_responses": "let_response", "exit_exchanges": "exit",
          "overflow_reductions": "overflow_reduction"}


def compose(struct, code):
    """The per-kind counts `code` issues for structural counts `struct`."""
    out = {}
    for name, event in EVENTS.items():
        for kind, per in ISSUES[code][event].items():
            out[kind] = out.get(kind, 0) + struct[name] * per
    return {k: v for k, v in out.items() if v}


def structure(counts, code, *, comm, reuse, n_ranks):
    """The structural counts of one run from its per-kind collective
    counts (`code` "jax": the script's count_collectives of the JAX
    program; "port": RingGroup.collectives). Raises unless they recompose
    into exactly `counts` and fit the run: P - 1 ring shifts an
    evaluation under comm="ring", one LET response an evaluation under
    "let", one LET request an evaluation per step or a block under the
    rebuild interval, one exit exchange."""
    iss = ISSUES[code]
    rep_kind = "pmin" if code == "jax" else "all_reduce:max"
    shift_kind = "ppermute" if code == "jax" else "shift"
    sum_kind = "psum" if code == "jax" else "all_reduce:sum"
    get = lambda kind: counts.get(kind, 0)  # noqa: E731
    rep = get(rep_kind) // iss["repartition"][rep_kind]
    trees = ((get("all_gather") - rep * iss["repartition"]["all_gather"])
             // iss["tree"]["all_gather"])
    plans = rep if reuse else 0
    evals = trees - plans
    let = (get("all_to_all") - rep * iss["repartition"]["all_to_all"]
           - iss["exit"]["all_to_all"])
    requests = (plans if reuse else evals) if comm == "let" else 0
    struct = {
        "repartitions": rep, "tree_builds": trees, "plans": plans,
        "evaluations": evals,
        "ring_shifts": get(shift_kind) // iss["ring_shift"][shift_kind],
        "let_requests": requests, "let_responses": let - requests,
        "exit_exchanges": 1,
        "overflow_reductions": (get(sum_kind)
                                - rep * iss["repartition"].get(sum_kind, 0)),
    }
    want_shifts = evals * (n_ranks - 1) if comm == "ring" else 0
    want_resp = evals if comm == "let" else 0
    if (compose(struct, code) != {k: v for k, v in counts.items() if v}
            or struct["ring_shifts"] != want_shifts
            or struct["let_responses"] != want_resp
            or struct["overflow_reductions"] != 1):
        raise AssertionError(f"{code} counts {counts} do not recompose as "
                             f"a {comm} run (reuse {reuse}): {struct}")
    return struct


def make_cfg(n, comm, near=256, far=512):
    """The script's configuration (its budgets by default)."""
    return SimConfig(n=n, ic="plummer", dt=1e-4, softening=0.01,
                     force="barnes_hut", bh_leaf_size=32,
                     bh_near_budget=near, bh_far_budget=far,
                     bh_distributed=True, bh_comm=comm)


def count_run(pool, cfg, n_steps):
    """(per-kind collective counts, kernel launches, overflow) of one
    make_distributed_run on every rank of pool from the config's own ICs
    (every rank must count the same)."""
    outs = pool.run(tasks.sharded, cfg.to_json(), None, "distributed",
                    n_steps)
    stats = mesh.LAST_RANK_STATS
    counts = stats[0]["collectives"]
    for r, st in enumerate(stats):
        if st["collectives"] != counts:
            raise AssertionError(f"rank {r} counted {st['collectives']}, "
                                 f"rank 0 {counts}")
    launches = {k: v for k, v in stats[0]["launches"].items() if v}
    return counts, launches, outs[0]["overflow"]


def probe(pool, n, n_steps, k, comms, device, out=None, near=256, far=512):
    """Both runs of each comm on pool; emits one line a run and one of the
    reductions; returns every record."""
    card = measure.card_of(device)
    base = {"tool": "dist_collectives_probe", "card": card, "n": n,
            "steps": n_steps, "k": k, "devices": pool.world_size,
            "near": near, "far": far}
    records, totals = [], {}
    for comm in comms:
        for run, rebuild in (("per_step_run", 1), ("reuse_run", k)):
            cfg = make_cfg(n, comm, near, far).replace(
                bh_rebuild_every=rebuild)
            counts, launches, overflow = count_run(pool, cfg, n_steps)
            struct = structure(counts, "port", comm=comm,
                               reuse=rebuild > 1, n_ranks=pool.world_size)
            total = sum(counts.values())
            jax_total = sum(compose(struct, "jax").values())
            totals[(comm, run)] = (total, jax_total)
            rec = {**base, "comm": comm, "run": run, "rebuild_every": rebuild,
                   "counts": counts, "total": total,
                   "per_step": total / n_steps, "structure": struct,
                   "jax_equivalent_total": jax_total, "overflow": overflow,
                   "launches_rank0": launches}
            measure.emit(rec, out)
            records.append(rec)
    summary = {**base, "reduction": {
        comm: {"port": 1.0 - totals[(comm, "reuse_run")][0]
               / totals[(comm, "per_step_run")][0],
               "jax_equivalent": 1.0 - totals[(comm, "reuse_run")][1]
               / totals[(comm, "per_step_run")][1]}
        for comm in comms}, "issues": ISSUES}
    measure.emit(summary, out)
    records.append(summary)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--comm", nargs="+", default=["ring", "let"],
                    choices=("ring", "let"))
    ap.add_argument("--near", type=int, default=256)
    ap.add_argument("--far", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    with RankPool(args.devices, dev) as pool:
        return probe(pool, args.n, args.steps, args.k, args.comm, dev,
                     args.out, args.near, args.far)


if __name__ == "__main__":
    main()
