"""Whether a finer import granularity shrinks the LET essential set: the
port of scripts/let_granularity_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.let_granularity_probe
        [--n 1048576] [--ranks 8] [--ic plummer,disk] [--theta 0.72]
        [--leaf 0] [--device cuda] [--out FILE]

Geometry only (no kernel runs): split each source leaf into s
Hilbert-contiguous sub-tiles of G / s particles, each with its own
bounding sphere (`subtile_geometry`: the centroid of its live rows and the
largest distance to it), and import a sub-tile only where its own group
MAC fails against some live target leaf of the rank (`near_fail_mask`, the
script's test `r_src >= theta (|d| - r_tgt)`). For s = 1 (the leaf import
of today), 2, 4 and 8, and `fat_only_s8` (sub-tiles only for the leaves
whose radius exceeds 4x the median of the live leaves' radii, leaf
geometry elsewhere), the rows each rank imports from the other ranks
(mean, max, and the mean as a fraction of the ring's (P - 1) N / P rows),
then the largest per-owner-pair import in leaves
(`import_budget_pair_max_leaves`, what bh_import_budget caps; the auto is
n_leaves / P) and the fat leaves' fraction.

The median follows numpy's rule, as `jnp.median` does (the mean of the two
middle values; NaN, and so no fat leaf, where a padded tree has an empty
leaf), not torch's (the lower one). The tree is `bh._prepare` with
monopoles on the config's ICs (`get_ic`, seed 0, softening 0.01). `--leaf
0` resolves the leaf by the run's device (at 1M: 128 on the card, 256 on
the CPU, the JAX package's rule); the row prints it. The (1024, sources)
fail planes are built a target chunk at a time and freed before the next
(at s = 8, 1M and leaf 128: 65536 sources). One JSON line an IC.
`--device cpu` for the tests.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure

SPLITS = (2, 4, 8)
FAT_RADIUS = 4.0   # fat: radius > FAT_RADIUS x the median
CHUNK = 1024       # target leaves a fail plane


def subtile_geometry(pos_s, mass_s, leaf, s):
    """Bounding sphere (centroid of the live rows, radius the largest
    distance to it) and occupancy of each Hilbert-contiguous G / s
    sub-tile."""
    n_pad = pos_s.shape[0]
    g = leaf // s
    p = pos_s.reshape(n_pad // g, g, 3)
    live = (mass_s.reshape(n_pad // g, g) > 0)[..., None]
    cnt = torch.clamp(live.sum(1), min=1)
    com = torch.where(live, p, torch.zeros_like(p)).sum(1) / cnt
    d = torch.sqrt(torch.sum((p - com[:, None, :]) ** 2, dim=2))
    rad = torch.where(live[..., 0], d, torch.zeros_like(d)).amax(1)
    return com, rad, live[..., 0].any(1)


def near_fail_mask(tgt_com, tgt_r, src_com, src_r, theta):
    """(n_tgt, n_src) True where the group MAC fails (the source is near)."""
    d2 = torch.zeros((tgt_com.shape[0], src_com.shape[0]),
                     dtype=tgt_com.dtype, device=tgt_com.device)
    for c in range(3):
        dc = src_com[:, c][None, :] - tgt_com[:, c][:, None]
        d2 = d2 + dc * dc
    return src_r[None, :] >= theta * (torch.sqrt(d2) - tgt_r[:, None])


def needed_sources(tgt_com, tgt_r, tgt_live, src_com, src_r, src_occ,
                   theta):
    """(n_src,) True for the occupied sources whose MAC fails against some
    live target; the fail planes a CHUNK of targets at a time."""
    need = torch.zeros(src_com.shape[0], dtype=torch.bool,
                       device=src_com.device)
    for t0 in range(0, tgt_com.shape[0], CHUNK):
        fail = near_fail_mask(tgt_com[t0:t0 + CHUNK], tgt_r[t0:t0 + CHUNK],
                              src_com, src_r, theta)
        fail &= tgt_live[t0:t0 + CHUNK, None]
        need |= fail.any(0)
        del fail
    return need & src_occ


def granularity(ic, pos, mass, *, ranks, theta, leaf, device):
    """One IC's row on (pos, mass)."""
    n = pos.shape[0]
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        pos, mass, leaf_size=leaf, curve="hilbert", multipole_order=1)
    n_leaves = n_pad // leaf
    per = n_leaves // ranks
    leaf_com, leaf_r, leaf_m = tree.com[0], tree.radius[0], tree.mass[0]
    live = leaf_m > 0
    radii = np.where(live.cpu().numpy(), leaf_r.cpu().numpy(), np.nan)
    med_r = float(np.median(radii))
    row = {"tool": "let_granularity_probe", "card": measure.card_of(device),
           "ic": ic, "n": n, "leaf": leaf, "n_leaves": n_leaves,
           "ranks": ranks, "theta": theta,
           "ring_rows_per_rank": (ranks - 1) * n_pad // ranks,
           "variants": {}}

    def imports(src_com, src_r, src_occ, leaf_of_src):
        """Per rank: the sources outside its own leaf range that it
        needs."""
        for r in range(ranks):
            t0, t1 = r * per, (r + 1) * per
            need = needed_sources(leaf_com[t0:t1], leaf_r[t0:t1],
                                  live[t0:t1], src_com, src_r, src_occ,
                                  theta)
            yield r, need & ~((leaf_of_src >= t0) & (leaf_of_src < t1))

    def variant(label, src_com, src_r, src_occ, rows_per_src, leaf_of_src):
        rows = np.asarray([int(m.sum()) * rows_per_src for _, m in imports(
            src_com, src_r, src_occ, leaf_of_src)])
        row["variants"][label] = {
            "rows_per_rank_mean": float(rows.mean()),
            "rows_per_rank_max": int(rows.max()),
            "frac_of_ring": float(rows.mean() / row["ring_rows_per_rank"])}

    leaf_ids = torch.arange(n_leaves, device=leaf_com.device)
    variant("s1_leaf", leaf_com, leaf_r, live, leaf, leaf_ids)
    # The per-owner-pair import maxima in leaves (the s = 1 sets).
    pair_max = 0
    for r, m in imports(leaf_com, leaf_r, live, leaf_ids):
        pair_max = max(pair_max, int(m.reshape(ranks, per).sum(1).max()))
    row["import_budget_pair_max_leaves"] = pair_max
    row["import_budget_auto_leaves"] = per
    for s in SPLITS:
        com, rad, occ = subtile_geometry(pos_s, mass_s, leaf, s)
        src_leaf = torch.arange(n_leaves * s, device=com.device) // s
        variant(f"s{s}_subtile", com, rad, occ, leaf // s, src_leaf)
        del com, rad, occ
    # Sub-tiles (s = 8) for the fat leaves only, leaf geometry elsewhere:
    # a non-fat leaf appears 8 times with its own geometry, all 8 needed
    # together, leaf / 8 rows each.
    com8, rad8, occ8 = subtile_geometry(pos_s, mass_s, leaf, 8)
    fat = leaf_r > FAT_RADIUS * med_r
    fat_sub = fat.repeat_interleave(8)
    com_m = torch.where(fat_sub[:, None], com8,
                        leaf_com.repeat_interleave(8, dim=0))
    rad_m = torch.where(fat_sub, rad8, leaf_r.repeat_interleave(8))
    variant("fat_only_s8", com_m, rad_m, occ8 | live.repeat_interleave(8),
            leaf // 8, torch.arange(n_leaves * 8, device=com8.device) // 8)
    row["median_leaf_radius"] = med_r
    row["fat_leaves_frac"] = float(fat.to(torch.float32).mean())
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--ic", default="plummer,disk")
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--leaf", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    rows = []
    for ic in args.ic.split(","):
        cfg = SimConfig(n=args.n, ic=ic, theta=args.theta,
                        force="barnes_hut", softening=0.01, dt=1e-4)
        state = init_simulation(cfg, dev, compute_forces=False)
        row = granularity(ic, state.pos, state.mass, ranks=args.ranks,
                          theta=args.theta,
                          leaf=args.leaf or cfg.resolve_bh_leaf_size(dev),
                          device=dev)
        measure.emit(row, args.out)
        rows.append(row)
        del state
    return rows


if __name__ == "__main__":
    main()
