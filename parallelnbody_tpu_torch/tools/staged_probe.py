"""Dense against staged Barnes-Hut refinement on one CUDA device: the port
of scripts/staged_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.staged_probe [--n 1048576]
        [--theta 0.72] [--leaf 256] [--near 3584] [--far 2560]
        [--cand1 0] [--cand2 0] [--multipole 2]
        [--mode both|dense|staged|lists|phases] [--iters 5]
        [--ic plummer] [--device cuda] [--out FILE]

Inputs are the script's: the --ic family's positions and masses for
`SimConfig(n, ic, softening=0.01, dt=1e-4, force="barnes_hut")`, from its
seed. The candidate budgets resolve as `bh.resolve_refine("staged", ...)`
resolves them (printed). Lines, by --mode:

  every mode   prepare (`bh._prepare`, Hilbert curve);
  dense        traverse (stop level 1) + `bh.leaf_interactions`: ms of
  (both,       each, overflow, near entries a target leaf (mean, max);
  lists)
  staged       traverse (stop level 2) + `bh.build_interaction_lists_
  (both,       staged` (gather form, as the script builds it): ms of
  lists,       each, overflow, near and far entries a target leaf (mean,
  phases)      max), and the rejected level-2 nodes a target leaf (mean,
               max) against the level-2 candidate budget;
  phases       on the staged lists: the far field in one K4 launch
               (`bh_kernels.far_gather`) and K1 (`bh_kernels.near_field`),
               once on work items built beforehand and once building
               them inside the call, as `bh_accel` does. The script timed
               its TPU near kernel at two VMEM segment sizes instead; the
               port has no segments (ROADMAP.md, Removals);
  both, dense, the whole `bh.bh_accel` (compute_pot=False, the octet far
  staged       field, its default) in each refinement the mode names,
               with its overflow.

Each timed line has its events ms and busy ms (`measure.phase`: the mean
of --iters calls after a warm-up by CUDA events, and the kernels and
copies of one more call from torch.profiler). `--device cpu` (the tests)
runs every phase on the plain versions and times nothing. Every line is
one JSON object carrying the card's name and power limit (appended to
--out).
"""

from __future__ import annotations

import argparse

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import make_state
from parallelnbody_tpu_torch.models import get_ic
from parallelnbody_tpu_torch.ops import bh, bh_kernels
from parallelnbody_tpu_torch.tools import measure

MODES = ("both", "dense", "staged", "lists", "phases")


def _counts(valid):
    c = valid.sum(1)
    return float(c.double().mean()), int(c.max())


def probe(pos, mass, args, out=None):
    """The script's lines for --mode on pos / mass (on their device);
    emits and returns the records."""
    dev = pos.device
    base = {"tool": "staged_probe", "card": measure.card_of(dev),
            "n": pos.shape[0], "mode": args.mode}
    records = []

    def run(name, fn, **info):
        got, times = measure.phase(fn, args.iters, dev)
        rec = {**base, "phase": name, **times, **info}
        records.append(rec)
        return got

    def emit(**extra):
        rec = records[-1]
        rec.update(extra)
        measure.emit(rec, out)

    pos_s, mass_s, _, tree, _, n_pad = run("prepare", lambda: bh._prepare(
        pos, mass, leaf_size=args.leaf, curve="hilbert",
        multipole_order=args.multipole))
    n_leaves = n_pad // args.leaf
    emit(n_leaves=n_leaves, levels=tree.n_levels)
    _, cands = bh.resolve_refine("staged", (args.cand2, args.cand1),
                                 tree.n_levels, args.near, args.far)
    if args.mode in ("both", "lists", "dense"):
        _, rej1 = run("dense traverse", lambda: bh.traverse(
            tree, args.theta, stop_level=1))
        emit()
        ni, nv, _, _, of = run("dense lists", lambda: bh.leaf_interactions(
            tree, rej1, args.theta, start_leaf=0, n_slice=n_leaves,
            near_budget=args.near, far0_budget=args.far))
        mean, top = _counts(nv)
        emit(overflow=int(of), near_mean=mean, near_max=top)
        del rej1, ni, nv
    if args.mode in ("both", "lists", "staged", "phases"):
        fm2, rej2 = run("staged traverse", lambda: bh.traverse(
            tree, args.theta, stop_level=2))
        emit()
        ni2, nv2, fi2, fv2, nodes_all, of2 = run(
            "staged lists", lambda: bh.build_interaction_lists_staged(
                tree, fm2, rej2, theta=args.theta, start_leaf=0,
                n_slice=n_leaves, near_budget=args.near, far_budget=args.far,
                cand2_budget=cands[0], cand1_budget=cands[1],
                dtype=pos_s.dtype))
        (n_mean, n_max), (f_mean, f_max) = _counts(nv2), _counts(fv2)
        r_mean, r_max = _counts(rej2)
        emit(overflow=int(of2), near_mean=n_mean, near_max=n_max,
             far_mean=f_mean, far_max=f_max, rej2_mean=r_mean,
             rej2_max=r_max, cand_budgets=list(cands))
        del fm2, rej2
    if args.mode == "lists":
        return records
    if args.mode == "phases":
        tgt = pos_s.reshape(n_leaves, args.leaf, 3)
        fkw = dict(g=1.0, softening=0.01, compute_pot=False)
        run("K4 far (combined)", lambda: bh_kernels.far_gather(
            tgt, nodes_all, fi2, fv2, **fkw))
        emit()
        work = bh_kernels.near_work(nv2)
        run("K1 near (items prebuilt)", lambda: bh_kernels.near_field(
            pos_s, mass_s, tgt, ni2, nv2, work=work, **fkw))
        emit()
        run("K1 near (items built in the call)",
            lambda: bh_kernels.near_field(pos_s, mass_s, tgt, ni2, nv2,
                                          **fkw))
        emit()
        return records
    for refine in (("dense", "staged") if args.mode == "both"
                   else (args.mode,)):
        _, _, of = run(f"bh_accel[{refine}]", lambda: bh.bh_accel(
            pos, mass, leaf_size=args.leaf, theta=args.theta, g=1.0,
            softening=0.01, near_budget=args.near, far0_budget=args.far,
            multipole=args.multipole, compute_pot=False, refine=refine,
            cand_budgets=cands))
        emit(overflow=int(of))
    return records


def inputs(args, dev):
    """The script's inputs: the --ic family's positions and masses from
    the config's seed, on dev."""
    cfg = SimConfig(n=args.n, ic=args.ic, softening=0.01, dt=1e-4,
                    force="barnes_hut")
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    pos, vel, mass = get_ic(args.ic)(gen, cfg)
    state = make_state(pos, vel, mass, seed=cfg.seed, device=dev)
    return state.pos, state.mass


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--near", type=int, default=3584)
    ap.add_argument("--far", type=int, default=2560)
    ap.add_argument("--cand1", type=int, default=0)
    ap.add_argument("--cand2", type=int, default=0)
    ap.add_argument("--multipole", type=int, default=2)
    ap.add_argument("--mode", default="both", choices=MODES)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ic", default="plummer")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    pos, mass = inputs(args, dev)
    return probe(pos, mass, args, out=args.out)


if __name__ == "__main__":
    main()
