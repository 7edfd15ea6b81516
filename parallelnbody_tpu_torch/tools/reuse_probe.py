"""Tree and list reuse across steps on one CUDA device: the port of
scripts/reuse_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.reuse_probe [--n 1048576]
        [--dt 1e-4] [--ic plummer] [--k 16] [--iters 5] [--device cuda]
        [--out FILE]

The configuration is the script's `make_cfg` (its budgets are
configuration, kept as they are) with the leaf size the run's device
resolves (128 on the card up to N = 2^23). The evaluation is split at the
list boundary (`make_plan_eval`, which tools/auto_rules.py's plan_eval
measures too):

  full      `bh.bh_accel`, sort + tree + traversal + lists + kernels +
            unsort, octet far field;
  plan      `bh._prepare` + `bh.bh_plan_lists` (traversal, lists, K1's
            work items and K2's launch order), what a rebuild block pays
            once;
  evaluate  `bh.bh_eval_lists`, the pyramid refresh and K2 + K1 on the
            frozen lists, what every step of a block pays.

Each is timed (events ms, the mean of --iters calls after a warm-up by
CUDA events, and busy ms from torch.profiler, `measure.phase`), then the
block average (plan + k x evaluate) / k at k = 2, 4, 8, 16 against full.
A timed run whose lists clipped (overflow > 0) raises, as
tools/auto_rules.py's rows do: the budgets must cover the run.

Then the accuracy of reuse over a real trajectory: leapfrog (KDK) in
sorted order, driven by the frozen lists' forces, from the state the plan
sorted (velocities gathered by its permutation). At steps 1, 2, 4, 8, 16
and 32 (those up to --k) it prints the rms relative difference of the
reused forces from a fresh `bh_accel` at the same positions, and the
sampled rms force error against the direct sum (`rms_force_error_sample`,
k = 2048). `--device cpu` (the tests) runs the plain versions and times
nothing. Every line is one JSON object carrying the card's name and power
limit (appended to --out).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

BLOCKS = (2, 4, 8, 16)
CHECKPOINTS = (1, 2, 4, 8, 16, 32)
RMS_K = 2048


def make_cfg(n: int, dt: float, ic: str) -> SimConfig:
    """The script's configuration per N (its budget choices)."""
    common = dict(ic=ic, integrator="leapfrog", softening=0.01,
                  dt=dt, force="barnes_hut", theta=0.72,
                  track_potential=False)
    if ic == "galaxy_collision":
        return SimConfig(n=n, bh_near_budget=5120, bh_far_budget=2048,
                         **common)
    if n <= 2 * 1048576:
        return SimConfig(n=n, bh_near_budget=3584, bh_far_budget=1536,
                         **common)
    return SimConfig(n=n, bh_leaf_size=256, bh_refine="staged",
                     bh_near_budget=512, bh_far_budget=2816,
                     bh_cand_budget=512, bh_cand2_budget=256, **common)


def make_plan_eval(cfg: SimConfig):
    """(plan, evaluate, full, refine) for a config whose leaf size is
    resolved: the bh_accel pipeline split at the list boundary.
    plan(pos, mass) -> (pos_s, mass_s, perm, bh.BHListPlan) runs the sort,
    tree, traversal and octet lists with K1's work items and K2's launch
    order; evaluate(pos_s, mass_s, lists) -> (acc, pot) in sorted order
    rebuilds only the multipole pyramid from the current sorted positions
    and evaluates the frozen lists; full(pos, mass) -> (acc, pot,
    overflow) is bh_accel with the octet far field. All three in one
    window, at the settings cfg resolves to (bh.BHSetup)."""
    setup = dataclasses.replace(bh.BHSetup.of(cfg), sections=1,
                                far_mode="octet")
    kw = dict(leaf_size=setup.leaf, g=cfg.g, softening=cfg.softening,
              multipole=cfg.bh_multipole, max_levels=cfg.bh_max_levels,
              compute_pot=cfg.track_potential)

    def plan(pos, mass):
        pos_s, mass_s, perm, tree, _, _ = bh._prepare(
            pos, mass, leaf_size=setup.leaf, curve=cfg.bh_curve,
            multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
        return pos_s, mass_s, perm, bh._plan(tree, setup)

    def evaluate(pos_s, mass_s, lists):
        return bh.bh_eval_lists(pos_s, mass_s, lists, n_live=cfg.n, **kw)

    def full(pos, mass):
        return bh._accel(pos, mass, setup)

    return plan, evaluate, full, setup.refine


def _rel_rms(a, b):
    """sqrt(mean |a - b|^2 / mean |b|^2) over rows."""
    num = torch.mean(torch.sum((a - b) ** 2, dim=1))
    return float(torch.sqrt(num / torch.mean(torch.sum(b * b, dim=1))))


def trajectory(cfg, pos, vel, mass, k, plan, evaluate, full):
    """The reused-list leapfrog of the script from (pos, vel, mass): one
    record {"step", "reuse_vs_fresh_rms", "vs_direct_rms"} at each
    checkpoint up to step k."""
    n = cfg.n
    pos_s, mass_s, perm, lists = plan(pos, mass)
    vel_s = torch.cat([vel, vel.new_zeros((pos_s.shape[0] - n, 3))])[perm]
    dt = torch.as_tensor(cfg.dt, dtype=pos_s.dtype, device=pos_s.device)
    ps, vs = pos_s, vel_s
    acc = evaluate(ps, mass_s, lists)[0]
    out = []
    for j in range(1, k + 1):
        vh = vs + 0.5 * dt * acc
        ps = ps + dt * vh
        acc = evaluate(ps, mass_s, lists)[0]
        vs = vh + 0.5 * dt * acc
        if j in CHECKPOINTS:
            fresh = full(ps[:n], mass_s[:n])[0]
            out.append({"step": j,
                        "reuse_vs_fresh_rms": _rel_rms(acc[:n], fresh),
                        "vs_direct_rms": rms_force_error_sample(
                            ps[:n], mass_s[:n], acc[:n], g=cfg.g,
                            softening=cfg.softening, k=RMS_K)})
    return out


def _gate(rec):
    if rec["overflow"]:
        raise AssertionError(f"clipped lists, the timed run does other "
                             f"work than its configuration states: {rec}")
    return rec


def probe(cfg, state, k, iters, out=None):
    """Times and the trajectory for cfg (leaf resolved) from state; emits
    and returns the records."""
    dev = state.pos.device
    plan, evaluate, full, refine = make_plan_eval(cfg)
    base = {"tool": "reuse_probe", "card": measure.card_of(dev), "n": cfg.n,
            "leaf": cfg.resolve_bh_leaf_size(), "refine": refine,
            "dt": cfg.dt, "near": cfg.bh_near_budget,
            "far": cfg.bh_far_budget}
    records = []

    def timed(name, fn, overflow):
        got, times = measure.phase(fn, iters, dev)
        rec = _gate({**base, "phase": name, **times,
                     "overflow": int(overflow(got))})
        measure.emit(rec, out)
        records.append(rec)
        return got

    timed("full bh_accel", lambda: full(state.pos, state.mass),
          lambda o: o[2])
    pos_s, mass_s, _, lists = timed(
        "plan", lambda: plan(state.pos, state.mass), lambda o: o[3].overflow)
    timed("reuse eval", lambda: evaluate(pos_s, mass_s, lists),
          lambda o: 0)
    del pos_s, mass_s, lists
    t_full, t_plan, t_ev = (r["ms"] for r in records)
    if t_full is not None:
        rec = {**base, "blocks": {
            str(b): {"ms_per_step": (t_plan + b * t_ev) / b,
                     "vs_full": (t_plan + b * t_ev) / b / t_full - 1}
            for b in BLOCKS}}
        measure.emit(rec, out)
        records.append(rec)
    for row in trajectory(cfg, state.pos, state.vel, state.mass, k, plan,
                          evaluate, full):
        rec = {**base, **row}
        measure.emit(rec, out)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--dt", type=float, default=1e-4)
    ap.add_argument("--ic", default="plummer")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    cfg = make_cfg(args.n, args.dt, args.ic).with_resolved_leaf(dev)
    state = init_simulation(cfg, dev, compute_forces=False)
    return probe(cfg, state, args.k, args.iters, args.out)


if __name__ == "__main__":
    main()
