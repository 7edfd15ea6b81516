"""Mask-fill statistics of an octet-compressed NEAR list on one CUDA
device: the port of scripts/near_octet_stats.py.

    python3 -m parallelnbody_tpu_torch.tools.near_octet_stats
        [--n 1048576] [--theta 0.72] [--leaf 256] [--near 3584]
        [--far 2816] [--iters 5] [--device cuda] [--out FILE]

K2 reads the far list as 8-sibling tiles with a child mask; K1 could read
the near list so too: 8 sibling leaves are 8 * G consecutive sorted
particles. The cost is padding: masked-out siblings still pay their pairs.
For each target leaf, its near list grouped by source octet (idx // 8):
fill = entries / (8 * octets), and the pairs an octet-read K1 would
evaluate against K1's own (`pair_mult_if_octet`).

Inputs are the script's: the Plummer positions and masses of
`SimConfig(n, ic="plummer", softening=0.01, dt=1e-4, force="barnes_hut",
theta)` from its seed; `bh._prepare` (Hilbert curve, quadrupoles),
`bh.traverse` and `bh.leaf_interactions` at --near / --far. The script's
per-target `np.unique` loop is a row sort on the device that counts each
row's distinct octets; the per-row counts come to the host only for the
percentiles. The script's JSON (near_count, octets_per_target, mask_fill,
pair_mult_if_octet) is printed with the list overflow and the leaf
count, which the script printed on a line of its own. The script's
docstring gave break-even fills from TPU timings; they are not carried
over (on the card K8 found no measurable list-read cost, `PERF.md` §6).

Each phase (prepare, traverse, lists, octet statistics) has its events
ms and busy ms (`measure.phase`, the mean of --iters calls after a
warm-up). `--device cpu` (the tests) runs the plain versions and times
nothing. Every line is one JSON object carrying the card's name and power
limit (appended to --out).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure, staged_probe


def octet_counts(near_idx, near_valid):
    """(entries, octets) per target row: the live list length and the
    number of distinct source octets (idx // 8) among its entries, by one
    row sort."""
    octs = torch.where(near_valid, near_idx // 8,
                       torch.full_like(near_idx, bh.INT32_MAX))
    octs = torch.sort(octs, dim=1).values
    live = octs != bh.INT32_MAX
    new = torch.ones_like(live)
    new[:, 1:] = octs[:, 1:] != octs[:, :-1]
    return (torch.sum(live, dim=1), torch.sum(new & live, dim=1))


def summary(counts, n_octs):
    """The script's JSON from the per-row counts (numpy int arrays): rows
    with no entry are left out of the octet and fill statistics, as the
    script's loop skips them."""
    keep = counts > 0
    octs = n_octs[keep]
    fills = counts[keep] / (8 * octs)
    return {
        "near_count": {"mean": float(counts.mean()),
                       "max": int(counts.max())},
        "octets_per_target": {"mean": float(octs.mean()),
                              "p50": int(np.percentile(octs, 50)),
                              "max": int(octs.max())},
        "mask_fill": {"mean": float(fills.mean()),
                      "p10": float(np.percentile(fills, 10)),
                      "p50": float(np.percentile(fills, 50)),
                      "p90": float(np.percentile(fills, 90))},
        "pair_mult_if_octet": float((8 * octs.sum()) / counts.sum()),
    }


def stats(pos, mass, args, out=None):
    """The script's statistics on pos / mass (on their device); emits and
    returns the records (one a phase, the statistics last)."""
    dev = pos.device
    base = {"tool": "near_octet_stats", "card": measure.card_of(dev),
            "n": pos.shape[0], "theta": args.theta, "leaf": args.leaf,
            "near": args.near, "far": args.far}
    records = []

    def run(name, fn):
        got, times = measure.phase(fn, args.iters, dev)
        records.append({**base, "phase": name, **times})
        measure.emit(records[-1], out)
        return got

    _, _, _, tree, _, n_pad = run("prepare", lambda: bh._prepare(
        pos, mass, leaf_size=args.leaf, curve="hilbert", multipole_order=2))
    n_leaves = n_pad // args.leaf
    _, rej1 = run("traverse", lambda: bh.traverse(tree, args.theta))
    near_idx, near_valid, _, _, overflow = run(
        "leaf_interactions", lambda: bh.leaf_interactions(
            tree, rej1, args.theta, start_leaf=0, n_slice=n_leaves,
            near_budget=args.near, far0_budget=args.far))
    counts, n_octs = run("octet statistics",
                         lambda: octet_counts(near_idx, near_valid))
    rec = {**base, "n_leaves": n_leaves, "overflow": int(overflow),
           **summary(counts.cpu().numpy(), n_octs.cpu().numpy())}
    records.append(rec)
    measure.emit(rec, out)
    return records


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--near", type=int, default=3584)
    ap.add_argument("--far", type=int, default=2816)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    args.ic = "plummer"
    dev = measure.device_of(args.device)
    pos, mass = staged_probe.inputs(args, dev)
    return stats(pos, mass, args, out=args.out)


if __name__ == "__main__":
    main()
