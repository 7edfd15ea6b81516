"""Sectioned Barnes-Hut evaluation (bh_sections) on one CUDA device: the
port of scripts/sections_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.sections_probe [--n 16777216]
        [--sections 1 4] [--theta 0.72] [--leaf 256] [--near 512]
        [--far 3072] [--iters 3] [--device cuda] [--out FILE]

Sectioning the target leaves into windows divides the traversal planes,
the staged lists and their sort buffers by the section count while the
sources stay whole. For each section count, `bh.bh_accel` on the script's
Plummer particles (`get_ic("plummer")`, seed 0, softening 0.01) at its
leaf, theta and budgets, staged refinement with candidate budgets (256,
512), quadrupoles, no potential: one JSON line with the resolved sections,
the overflow, ms per evaluation (the mean of --iters calls after the first
by CUDA events) and the peak device memory of the first call
(`section_memory.peak_phase`). The budgets are the TPU's choices for leaf
256 and may clip; every row prints its overflow.

Check (beyond the script): every section count's forces are bit-equal to
those of the first count that ran (the list starts with 1): sectioning
changes the windows, never the physics. A mismatch raises.

Out of memory is a result here, as in the script, whose question is
whether a size fits: `torch.cuda.OutOfMemoryError` alone is caught and
printed as a row with "oom": true and the peak reached; any other
exception propagates. `--device cpu` (the tests) runs the plain versions
and times nothing. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.tools.section_memory import GIB, peak_phase

CAND_BUDGETS = (256, 512)


def particles(n, dev):
    """The script's input: seed-0 Plummer particles at softening 0.01."""
    state = init_simulation(SimConfig(n=n, ic="plummer", softening=0.01,
                                      dt=1e-4, force="barnes_hut"), dev,
                            compute_forces=False)
    return state.pos, state.mass


def probe(pos, mass, sections, *, leaf, theta, near, far, iters, dev,
          out=None):
    """One row a section count; returns the rows."""
    n = pos.shape[0]
    n_leaves = bh.plan_tree(n, leaf)[0]
    base = {"tool": "sections_probe", "card": measure.card_of(dev), "n": n,
            "n_leaves": n_leaves, "leaf": leaf, "theta": theta,
            "near": near, "far": far, "cand_budgets": list(CAND_BUDGETS)}

    def accel(s):
        return bh.bh_accel(pos, mass, leaf_size=leaf, theta=theta, g=1.0,
                           softening=0.01, near_budget=near,
                           far0_budget=far, multipole=2, compute_pot=False,
                           refine="staged", cand_budgets=CAND_BUDGETS,
                           sections=s)

    rows, ref = [], None
    for s in sections:
        rec = {**base, "sections": s,
               "resolved": bh.resolve_sections(s, n_leaves, "staged")}
        try:
            (acc, _, of), rec["peak_gib"], rec["first_s"] = peak_phase(
                lambda: accel(s), dev)
        except torch.cuda.OutOfMemoryError as e:
            on_card = dev.type == "cuda"
            rec.update(oom=True, error=str(e).splitlines()[0],
                       peak_gib=(torch.cuda.max_memory_allocated(dev) / GIB
                                 if on_card else None))
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            measure.emit(rec, out)
            rows.append(rec)
            continue
        rec["oom"] = False
        rec["overflow"] = int(of)
        rec["ms"] = (measure.events_ms(lambda: accel(s), iters)
                     if dev.type == "cuda" else None)
        if ref is None:
            ref = (s, acc)
        elif not torch.equal(acc, ref[1]):
            raise AssertionError(
                f"sections {s}: forces differ from sections {ref[0]}'s "
                f"(max abs {float((acc - ref[1]).abs().max()):.3e})")
        rec["bit_equal_to"] = ref[0]
        del acc
        measure.emit(rec, out)
        rows.append(rec)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16777216)
    ap.add_argument("--sections", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--near", type=int, default=512)
    ap.add_argument("--far", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    pos, mass = particles(args.n, dev)
    return probe(pos, mass, args.sections, leaf=args.leaf, theta=args.theta,
                 near=args.near, far=args.far, iters=args.iters, dev=dev,
                 out=args.out)


if __name__ == "__main__":
    main()
