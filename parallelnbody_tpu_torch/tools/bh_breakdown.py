"""Per-phase times and list statistics of the Barnes-Hut force evaluation
(`bh.bh_accel`) on one CUDA device: the port of scripts/bh_breakdown.py.

    python3 -m parallelnbody_tpu_torch.tools.bh_breakdown [--n 1048576]
        [--theta 0.7] [--leaf 256] [--near 512] [--far 2048]
        [--multipole 2] [--curve hilbert] [--lists-only]
        [--far-mode gather|octet] [--refine dense|staged] [--rebuild 8]
        [--config FILE] [--iters 5] [--device cuda] [--out FILE]

Inputs are the script's: `init_simulation(SimConfig(n, ic="plummer",
softening=0.01, dt=1e-4, force="barnes_hut"))` with the flags' leaf,
theta, budgets, multipole order and curve, the potential computed
(`bh_accel`'s default). `--config FILE` takes a configuration instead,
through `prepare_simulation` (its auto budgets calibrated, its leaf,
theta, refinement, far mode, multipole order, curve, softening and
potential setting), in place of those flags.

The phases, run one after another as the port composes them, each on the
outputs of the ones before it:

  prepare       `bh._prepare` (pad, curve sort, multipole pyramid):
                n_pad, n_leaves, levels and the leaf radius statistics;
  traverse      `bh.traverse` (stop level 1 dense, 2 staged): the upper
                accepted nodes and the stop level's rejects a target leaf;
  lists         `bh.leaf_interactions` and the upper list of the gather
                form (`bh._upper_list`), or `bh.build_interaction_lists_
                octet`, or `bh.build_interaction_lists_staged`: overflow,
                near and far entries a target leaf, the near pairs and
                their least time on the card (`measure.pair_bound`);
  near_work     K1's work items (`bh_kernels.near_work`);
  far_order     K2's launch order (`bh_kernels.far_order`; octet);
  refresh       the pyramid refresh of a frozen-list evaluation
                (`bh._refresh_nodes8`, build_tree + _nodes_all_octet;
                octet);
  K2 / K4       the far field: K2 on the octet list, K4 on the staged
                gather list, or K4 on the upper and on the leaf list (the
                two launches of `bh.eval_far_lists`), each with its terms
                and bound;
  K1            the near field on the prebuilt items, its pairs and bound;
  unsort        `bh._unsort`, the scatter `bh_accel` runs (not the
                script's 5-operand sort).

Then the whole `bh_accel` on the same inputs, beside the sum of the
phases. The composed forces must equal its forces within rtol 2e-4 / atol
2e-5 (the largest difference is printed; beyond, the tool raises). The
summary adds two composed rows: per step, the phases `bh_accel` runs, each
once (every phase but the refresh: the list build returns the node
table), and, in octet mode, at rebuild k (`--rebuild`): the plan phases
(prepare, traverse, lists, near_work, far_order) once plus k x (refresh +
K2 + K1), over k. And the peak device memory of the run.

Each phase gets two numbers on the card: its events ms (`measure.phase`:
the mean of --iters calls after a warm-up by CUDA events, the wall time on
the stream, host waits included) and its busy ms (the kernels and copies
of one more call, from torch.profiler); busy / events is its busy share.
Host reads inside a phase (overflow counts, the staged row blocks, the
items' sizes) wait on the stream, so a phase can last longer than its
busy time: that difference is what the split is for.

What differs from the script: no sync floor (CUDA events need none); the
near pairs' least time on the card in place of the TPU's all-pairs rate;
the scatter unsort; no `use_pallas_bh()`: on the card the kernels always
run, and `--device cpu` (the tests) runs their plain versions and times
nothing. Statistics use the script's quantile rule (`stats`), not
`np.percentile`. Every line is one JSON object carrying the card's name
and power limit (appended to --out).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation, prepare_simulation
from parallelnbody_tpu_torch.ops import bh, bh_kernels
from parallelnbody_tpu_torch.tools import measure

RTOL, ATOL = 2e-4, 2e-5      # composed phases against bh_accel
GIB = 2**30
PLAN = ("prepare", "traverse", "leaf_interactions", "upper_list",
        "build_interaction_lists_octet", "build_interaction_lists_staged",
        "near_work", "far_order")
EVAL = ("refresh", "K2 far_octet", "K1 near_field")


@dataclasses.dataclass(frozen=True)
class Spec:
    """One Barnes-Hut evaluation: `bh.bh_accel`'s arguments, refinement,
    candidate budgets and far mode resolved for the tree (`resolved`)."""

    leaf: int
    theta: float
    near: int
    far: int
    refine: str = "dense"
    far_mode: str = "auto"
    cands: tuple = (0, 0)
    multipole: int = 2
    curve: str = "hilbert"
    max_levels: int = 12
    g: float = 1.0
    softening: float = 0.01
    compute_pot: bool = True

    def resolved(self, n):
        n_levels = bh.plan_tree(n, self.leaf, self.max_levels)[2]
        refine, cands = bh.resolve_refine(self.refine, self.cands, n_levels,
                                          self.near, self.far)
        return dataclasses.replace(
            self, refine=refine, cands=cands,
            far_mode=bh.resolve_far_mode(self.far_mode, refine))

    def accel(self, pos, mass):
        """`bh.bh_accel` at this spec, in one window."""
        return bh.bh_accel(
            pos, mass, leaf_size=self.leaf, theta=self.theta, g=self.g,
            softening=self.softening, near_budget=self.near,
            far0_budget=self.far, curve=self.curve, multipole=self.multipole,
            max_levels=self.max_levels, compute_pot=self.compute_pot,
            refine=self.refine, cand_budgets=self.cands,
            far_mode=self.far_mode, sections=1)


def spec_of(cfg, far_mode=None):
    """The Spec of a (calibrated, leaf-resolved) configuration."""
    n_leaves = bh.plan_tree(cfg.n, cfg.resolve_bh_leaf_size(),
                            cfg.bh_max_levels)[0]
    refine = cfg.resolve_bh_refine()
    if bh.resolve_sections(cfg.bh_sections, n_leaves, refine) != 1:
        raise ValueError("the phases are timed over one window; "
                         f"{cfg.bh_sections} sections resolve to more")
    return Spec(leaf=cfg.resolve_bh_leaf_size(), theta=cfg.theta,
                near=cfg.resolve_bh_near_budget(),
                far=cfg.resolve_bh_far_budget(), refine=refine,
                far_mode=far_mode or cfg.bh_far_mode,
                cands=(cfg.bh_cand2_budget, cfg.bh_cand_budget),
                multipole=cfg.bh_multipole, curve=cfg.bh_curve,
                max_levels=cfg.bh_max_levels, g=cfg.g,
                softening=cfg.softening,
                compute_pot=cfg.track_potential).resolved(cfg.n)


def stats(values):
    """The script's statistics of a per-leaf tensor: mean and the sorted
    values at int(p * n) for p = 0.5, 0.9, 0.99 (not np.percentile), and
    the max. Integers stay integers."""
    c = torch.sort(values.reshape(-1)).values.cpu()
    n = c.numel()
    conv = float if c.is_floating_point() else int
    q = lambda p: conv(c[min(n - 1, int(p * n))])  # noqa: E731
    return {"mean": float(c.double().mean()), "p50": q(0.5), "p90": q(0.9),
            "p99": q(0.99), "max": conv(c[-1])}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _octet_children(keys, valid):
    """(L,) accepted children of each target leaf's octet list: the node
    rows K2 sweeps for it."""
    mask = torch.where(valid, keys & 0xFF, 0)
    return sum(((mask >> b) & 1).sum(1) for b in range(8))


def _far_work(tgt, table, entries, *lists):
    """Terms and least time of one far launch: G targets against each of
    `entries` node rows, the quadrupole term where the table has one."""
    flops = (measure.FLOPS_QUADRUPOLE if table.shape[1] >= 9
             else measure.FLOPS_MONOPOLE)
    terms = int(entries) * tgt.shape[1]
    return measure.pair_bound(terms, flops, 2 * _nbytes(tgt) + _nbytes(
        table, *lists) + 4 * tgt.shape[0] * tgt.shape[1])


def _near_work(pos_s, mass_s, tgt, idx, valid):
    """Pairs and least time of K1 on the lists."""
    pairs = int(valid.sum()) * tgt.shape[1] ** 2
    return measure.pair_bound(pairs, measure.FLOPS_MONOPOLE, _nbytes(
        pos_s, mass_s, idx, valid) + 16 * pos_s.shape[0])


def phases(pos, mass, spec, run, lists_only=False):
    """`bh_accel`'s phases for spec (resolved) one after another, each
    through run(name, fn, info) -> fn's output, where info(output) gives
    the phase's statistics. Returns the composed (acc, pot, overflow) in
    the caller's particle order, or None with lists_only (after the list
    build, as the script stops)."""
    leaf, stop = spec.leaf, 1 if spec.refine == "dense" else 2
    pos_s, mass_s, perm, tree, n, n_pad = run(
        "prepare", lambda: bh._prepare(
            pos, mass, leaf_size=leaf, curve=spec.curve,
            multipole_order=spec.multipole, max_levels=spec.max_levels),
        lambda o: {"n_pad": o[5], "n_leaves": o[5] // leaf,
                   "levels": o[3].n_levels,
                   "leaf_radius": stats(o[3].radius[0])})
    n_leaves = n_pad // leaf
    far_masks, rejects = run(
        "traverse", lambda: bh.traverse(tree, spec.theta, stop_level=stop),
        lambda o: {"upper_accepted": stats(sum(
            o[0][k].sum(1) for k in range(stop, tree.n_levels))),
            f"l{stop}_rejects": stats(o[1].sum(1))})
    kw = dict(theta=spec.theta, start_leaf=0, n_slice=n_leaves,
              near_budget=spec.near)
    dtype = pos_s.dtype

    def list_info(far_name):
        def info(o):
            near_valid, far_valid, overflow = o[1], o[3], o[-1]
            pairs = _near_work(pos_s, mass_s, pos_s.reshape(
                n_leaves, leaf, 3), o[0], near_valid)
            return {"overflow": int(overflow),
                    "near": stats(near_valid.sum(1)),
                    far_name: stats(far_valid.sum(1)),
                    "near_pairs": pairs["pairs"],
                    "near_bound_ms": pairs["bound_ms"]}
        return info

    if spec.refine == "staged":
        ni, nv, fi, fv, table, overflow = run(
            "build_interaction_lists_staged",
            lambda: bh.build_interaction_lists_staged(
                tree, far_masks, rejects, far_budget=spec.far,
                cand2_budget=spec.cands[0], cand1_budget=spec.cands[1],
                dtype=dtype, octet_far=spec.far_mode == "octet", **kw),
            list_info("far"))
    elif spec.far_mode == "octet":
        ni, nv, fi, fv, table, overflow = run(
            "build_interaction_lists_octet",
            lambda: bh.build_interaction_lists_octet(
                tree, far_masks, rejects, far_budget=spec.far, dtype=dtype,
                **kw), list_info("far"))
    else:
        ni, nv, fi, fv, overflow = run(
            "leaf_interactions", lambda: bh.leaf_interactions(
                tree, rejects, far0_budget=spec.far, **kw),
            list_info("far0"))
        up_idx, up_valid, nodes_up, table = run(
            "upper_list", lambda: bh._upper_list(tree, far_masks, dtype),
            lambda o: {"upper_width": o[2].shape[0]})
    del far_masks, rejects
    if lists_only:
        return None

    tgt = pos_s.reshape(n_leaves, leaf, 3)
    fkw = dict(g=spec.g, softening=spec.softening,
               compute_pot=spec.compute_pot)
    work = run("near_work", lambda: bh_kernels.near_work(
        nv, ni, sources=(n_leaves, leaf)),
               lambda o: {"items": None if o is None else o.items.shape[0]})
    if spec.far_mode == "octet":
        order = run("far_order", lambda: bh_kernels.far_order(fv))
        nodes8 = run("refresh", lambda: bh._refresh_nodes8(
            pos_s, mass_s, leaf_size=leaf, multipole=spec.multipole,
            max_levels=spec.max_levels, n_live=n))
        far = run("K2 far_octet", lambda: bh_kernels.far_octet(
            tgt, nodes8, fi, fv, order=order, **fkw),
            lambda o: _far_work(tgt, nodes8, _octet_children(fi, fv).sum(),
                                fi, fv))
    elif spec.refine == "staged":
        far = run("K4 far_gather", lambda: bh_kernels.far_gather(
            tgt, table, fi, fv, **fkw),
            lambda o: _far_work(tgt, table, fv.sum(), fi, fv))
    else:
        up = run("K4 far_gather upper", lambda: bh_kernels.far_gather(
            tgt, nodes_up, up_idx, up_valid, **fkw),
            lambda o: _far_work(tgt, nodes_up, up_valid.sum(), up_idx,
                                up_valid))
        lo = run("K4 far_gather leaf", lambda: bh_kernels.far_gather(
            tgt, table, fi, fv, **fkw),
            lambda o: _far_work(tgt, table, fv.sum(), fi, fv))
        far = (up[0] + lo[0], up[1] + lo[1])
    near = run("K1 near_field", lambda: bh_kernels.near_field(
        pos_s, mass_s, tgt, ni, nv, work=work, **fkw),
        lambda o: _near_work(pos_s, mass_s, tgt, ni, nv))
    acc, pot = far[0] + near[0], far[1] + near[1]
    del far, near, ni, nv, fi, fv
    acc, pot = run("unsort", lambda: bh._unsort(acc, pot, perm, n))
    return acc, pot, overflow


def _row(rec, names):
    """(events ms, busy ms) summed over the phases named, each None where a
    phase lacks it (the CPU; a profiled call that recorded no device
    activity)."""
    picked = [r for r in rec if r.get("phase") in names]
    sums = []
    for key in ("ms", "busy_ms"):
        vals = [r[key] for r in picked]
        sums.append(None if any(v is None for v in vals) else sum(vals))
    return sums


def breakdown(pos, mass, spec, *, iters=5, lists_only=False, rebuild=8,
              out=None, label=None):
    """Times `phases` for spec on pos / mass (on their device) and the
    whole `bh_accel`; emits and returns the records: one a phase, then the
    summary."""
    dev = pos.device
    spec = spec.resolved(pos.shape[0])
    base = {"tool": "bh_breakdown", "card": measure.card_of(dev),
            "label": label, "n": pos.shape[0], "refine": spec.refine,
            "far_mode": spec.far_mode, "leaf": spec.leaf,
            "theta": spec.theta, "budgets": [spec.near, spec.far,
                                             *spec.cands]}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    records = []

    def run(name, fn, info=None):
        got, times = measure.phase(fn, iters, dev)
        rec = {**base, "phase": name, **times}
        if info is not None:
            rec.update(info(got))
        measure.emit(rec, out)
        records.append(rec)
        return got

    composed = phases(pos, mass, spec, run, lists_only)
    if lists_only:
        return records
    acc, pot, overflow = composed
    whole = run("bh_accel", lambda: spec.accel(pos, mass))
    diff = measure.max_abs_err("composed phases against bh_accel", acc,
                               whole[0], RTOL, ATOL)
    if spec.compute_pot:
        diff = max(diff, measure.max_abs_err(
            "composed potential against bh_accel", pot, whole[1], RTOL,
            ATOL))
    if int(overflow) != int(whole[2]):
        raise AssertionError(f"overflow {int(overflow)} composed, "
                             f"{int(whole[2])} in bh_accel")
    step = _row(records, PLAN + ("K2 far_octet", "K4 far_gather",
                                 "K4 far_gather upper", "K4 far_gather leaf",
                                 "K1 near_field", "unsort"))
    summary = {**base, "summary": True, "overflow": int(overflow),
               "max_abs_diff": diff,
               "bh_accel_ms": records[-1]["ms"],
               "bh_accel_busy_ms": records[-1]["busy_ms"],
               "per_step_ms": step[0], "per_step_busy_ms": step[1]}
    if spec.far_mode == "octet":
        plan, ev = _row(records, PLAN), _row(records, EVAL)
        for key, p, e in zip(("rebuild_ms", "rebuild_busy_ms"), plan, ev):
            summary[key] = (None if p is None or e is None
                            else (p + rebuild * e) / rebuild)
        summary["rebuild"] = rebuild
    if dev.type == "cuda":
        summary["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    measure.emit(summary, out)
    records.append(summary)
    return records


def state_for(args, dev):
    """(state, spec) of the command line: the script's inputs, or the
    calibrated configuration of --config."""
    if args.config:
        with open(args.config) as f:
            cfg, state = prepare_simulation(SimConfig.from_json(f.read()),
                                            dev)
        return state, spec_of(cfg)
    cfg = SimConfig(n=args.n, ic="plummer", softening=0.01, dt=1e-4,
                    force="barnes_hut", theta=args.theta,
                    bh_leaf_size=args.leaf, bh_near_budget=args.near,
                    bh_far_budget=args.far, bh_multipole=args.multipole,
                    bh_curve=args.curve)
    state = init_simulation(cfg, dev, compute_forces=False)
    return state, Spec(leaf=args.leaf, theta=args.theta, near=args.near,
                       far=args.far, refine=args.refine,
                       far_mode=args.far_mode, multipole=args.multipole,
                       curve=args.curve)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--theta", type=float, default=0.7)
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--near", type=int, default=512)
    ap.add_argument("--far", type=int, default=2048)
    ap.add_argument("--multipole", type=int, default=2)
    ap.add_argument("--curve", default="hilbert")
    ap.add_argument("--lists-only", action="store_true",
                    help="stop after the list-build phase")
    ap.add_argument("--far-mode", default="gather",
                    choices=("gather", "octet"))
    ap.add_argument("--refine", default="dense", choices=("dense", "staged"))
    ap.add_argument("--rebuild", type=int, default=8)
    ap.add_argument("--config", default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    state, spec = state_for(args, dev)
    return breakdown(state.pos, state.mass, spec, iters=args.iters,
                     lists_only=args.lists_only, rebuild=args.rebuild,
                     out=args.out, label=args.config)


if __name__ == "__main__":
    main()
