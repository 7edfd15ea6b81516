"""Near-field refinement options at scale on one CUDA device: the port of
scripts/near_refine_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.near_refine_probe
        [--n 1048576] [--theta 0.72] [--leaf 256] [--chunk 512]
        [--ic plummer] [--iters 5] [--device cuda] [--out FILE]

The script's three questions, on the leaf-granularity near plane
(`leaf_r >= theta * (d - tgt_r)` over all leaf pairs):
  1. do a few fat (large-radius) source leaves dominate the near entries;
  2. if the near/far decision were refined to sub-groups of sub = 32, 64
     and 128 consecutive sorted particles (their own CoM and radius; sizes
     above the leaf are left out), how
     many near pairs remain, and how many subs pass the MAC instead (the
     "mid" class);
  3. of the refined entries, how many are full leaves (every sub near).

Inputs are the script's: the --ic family's positions and masses of
`SimConfig(n, ic, softening=0.01, dt=1e-4, force="barnes_hut", theta,
bh_leaf_size=leaf)` from its seed, `bh._prepare` (Hilbert curve,
monopoles). `group_moments`, `d_plane` and `chunk_stats` are the
script's, as plain torch on the device, over --chunk target leaves at a
time. The script turned pair counts into "ms-eq" at the TPU's near-kernel
rate; here the rate is the card's K1 (`near_rates.k1_rate`) on these
particles' own leaf-granularity near lists (the plane above, every entry
kept), measured in the same run and printed on the first line; on the CPU
it is null, and so is every "ms-eq".

Lines (JSON): the rate and the leaf radius percentiles; for each sub the
per-target sub and mid counts (mean and percentiles as the script
printed them), the near leaf entries and their pairs, the refined subs
and their pairs with the reduction, the full-leaf and partial entries
with the lane-padded pair count (partial entries at sub width padded to
128 lanes); for sub 32 the share of near entries listing the 8, 32, 128
and 512 fattest sources. Each sub's statistics pass has its events ms and
busy ms (`measure.phase`). `--device cpu` (the tests) runs the plain
versions and times nothing. Every line carries the card's name and power
limit (appended to --out).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure, near_rates, staged_probe

SUBS = (32, 64, 128)
FAT_TOPS = (8, 32, 128, 512)


def group_moments(pos_s, mass_s, size):
    """CoM + bounding radius of consecutive groups of `size` sorted
    particles: (com (k, 3), radius (k,), msum (k,))."""
    k = pos_s.shape[0] // size
    p = pos_s.reshape(k, size, 3)
    m = mass_s.reshape(k, size)
    msum = torch.sum(m, dim=1)
    com = (torch.sum(m[:, :, None] * p, dim=1)
           / torch.clamp(msum, min=1e-30)[:, None])
    r = bh._norm3(p - com[:, None, :])
    radius = torch.amax(torch.where(m > 0, r, 0.0), dim=1)
    return com, radius, msum


def d_plane(tgt_com, src_com):
    """(T, S) distances, the squares summed component by component."""
    d2 = torch.zeros((tgt_com.shape[0], src_com.shape[0]),
                     dtype=tgt_com.dtype, device=tgt_com.device)
    for c in range(3):
        dc = src_com[:, c][None, :] - tgt_com[:, c][:, None]
        d2 = d2 + dc * dc
    return torch.sqrt(d2)


def near_leaf_plane(tgt_com, tgt_r, leaf_com, leaf_r, theta):
    """The current near mask at leaf granularity (T, L)."""
    d = d_plane(tgt_com, leaf_com)
    return leaf_r[None, :] >= theta * (d - tgt_r[:, None])


def chunk_stats(tgt_com, tgt_r, leaf_com, leaf_r, sub_com, sub_r, *, theta,
                sub_per_leaf):
    """For one chunk of target leaves: (near leaf counts, near subs, full
    leaves, partial leaves, subs of partial leaves, source hits, mid
    counts), each per target but the source hits (per source leaf)."""
    near_leaf = near_leaf_plane(tgt_com, tgt_r, leaf_com, leaf_r, theta)
    ds = d_plane(tgt_com, sub_com)
    near_sub = sub_r[None, :] >= theta * (ds - tgt_r[:, None])
    t, ls = near_sub.shape
    near_sub = near_sub.reshape(t, ls // sub_per_leaf, sub_per_leaf)
    # Only subs inside leaf-level near entries count (the rest are far).
    near_sub = near_sub & near_leaf[:, :, None]
    k_sub = torch.sum(near_sub, dim=2)
    near_leaf_counts = torch.sum(near_leaf, dim=1)
    sub_counts = torch.sum(k_sub, dim=1)
    full = torch.sum(k_sub == sub_per_leaf, dim=1)
    partial = torch.sum((k_sub > 0) & (k_sub < sub_per_leaf), dim=1)
    partial_subs = torch.sum(torch.where(k_sub < sub_per_leaf, k_sub, 0),
                             dim=1)
    # mid class: subs of near leaves that pass the MAC on their own.
    mid_counts = near_leaf_counts * sub_per_leaf - sub_counts
    src_hits = torch.sum(near_leaf, dim=0)
    return (near_leaf_counts, sub_counts, full, partial, partial_subs,
            src_hits, mid_counts)


def _pct(a, q):
    return float(np.percentile(a, q))


def sub_pass(pos_s, mass_s, tree, theta, sub, chunk):
    """One sub size over every chunk of target leaves: per-target sub and
    mid counts (numpy) and the totals (near leaves, near subs, full,
    partial, partial subs) and the source hits, as the script sums
    them."""
    leaf_com, leaf_r = tree.com[0], tree.radius[0]
    n_leaves = leaf_com.shape[0]
    spl = pos_s.shape[0] // n_leaves // sub
    sub_com, sub_r, _ = group_moments(pos_s, mass_s, sub)
    outs = [chunk_stats(leaf_com[t0:t0 + chunk], leaf_r[t0:t0 + chunk],
                        leaf_com, leaf_r, sub_com, sub_r, theta=theta,
                        sub_per_leaf=spl)
            for t0 in range(0, n_leaves, chunk)]
    nl, ns, fl, pa, ps, _, mc = (torch.cat([o[i] for o in outs])
                                 for i in (0, 1, 2, 3, 4, 5, 6))
    hits = torch.stack([o[5] for o in outs]).sum(0)
    totals = [int(torch.sum(x, dtype=torch.int64)) for x in (nl, ns, fl, pa,
                                                             ps)]
    return (ns.cpu().numpy(), mc.cpu().numpy(), totals,
            hits.cpu().numpy().astype(np.float64))


def probe(pos, mass, args, out=None):
    """The script's lines on pos / mass (on their device); emits and
    returns the records."""
    dev = pos.device
    g = args.leaf
    pos_s, mass_s, _, tree, n, n_pad = bh._prepare(pos, mass, leaf_size=g,
                                                   curve="hilbert")
    n_leaves = n_pad // g
    leaf_com, leaf_r = tree.com[0], tree.radius[0]
    rad = leaf_r.cpu().numpy()
    near = torch.cat([near_leaf_plane(leaf_com[t0:t0 + args.chunk],
                                      leaf_r[t0:t0 + args.chunk], leaf_com,
                                      leaf_r, args.theta)
                      for t0 in range(0, n_leaves, args.chunk)])
    rate = near_rates.rates(pos_s, mass_s, near, args.iters)
    del near
    base = {"tool": "near_refine_probe", "card": measure.card_of(dev),
            "n": n, "n_leaves": n_leaves, "leaf": g, "theta": args.theta,
            "chunk": args.chunk}
    k1 = rate["k1_pairs_per_s"]
    records = [{**base, **rate,
                "leaf_radius": {"p50": float(np.median(rad)),
                                "p90": _pct(rad, 90), "p99": _pct(rad, 99),
                                "max": float(rad.max())}}]
    measure.emit(records[-1], out)
    for sub in (s for s in SUBS if s <= g):
        (sc, mc, totals, hits), times = measure.phase(
            lambda: sub_pass(pos_s, mass_s, tree, args.theta, sub,
                             args.chunk), args.iters, dev)
        tot_leaf, tot_sub, tot_full, tot_partial, tot_psubs = totals
        pairs_cur = tot_leaf * g * g
        pairs_ref = tot_sub * g * sub
        # partial entries at sub-tile width `sub`, padded to 128 lanes
        lane_eff = max(sub, 128) / sub
        pairs_eff = tot_full * g * g + tot_psubs * g * sub * lane_eff
        rec = {**base, "sub": sub, "sub_per_leaf": g // sub, **times,
               "sub_counts": {"mean": float(sc.mean()), "p50": _pct(sc, 50),
                              "p99": _pct(sc, 99), "p999": _pct(sc, 99.9),
                              "max": int(sc.max())},
               "mid_counts": {"mean": float(mc.mean()), "p99": _pct(mc, 99),
                              "max": int(mc.max()),
                              "total": float(mc.sum())},
               "near_leaf_entries": tot_leaf,
               "near_leaf_per_target": tot_leaf / n_leaves,
               "pairs_cur": pairs_cur,
               "ms_eq_cur": near_rates.ms_eq(pairs_cur, k1),
               "refined_subs": tot_sub, "pairs_ref": pairs_ref,
               "ms_eq_ref": near_rates.ms_eq(pairs_ref, k1),
               "reduction": pairs_cur / max(pairs_ref, 1),
               "full_entries": tot_full,
               "full_share": tot_full / max(tot_leaf, 1),
               "partial_entries": tot_partial, "partial_subs": tot_psubs,
               "pairs_eff": pairs_eff,
               "ms_eq_eff": near_rates.ms_eq(pairs_eff, k1)}
        if sub == SUBS[0]:
            # fat-source domination: cumulative near-entry share by radius
            order = np.argsort(-rad, kind="stable")
            cum = np.cumsum(hits[order]) / max(hits.sum(), 1)
            rec["fattest"] = [{"top": k, "share": float(cum[k - 1]),
                               "radius": float(rad[order[k - 1]])}
                              for k in FAT_TOPS if k <= n_leaves]
        records.append(rec)
        measure.emit(rec, out)
    return records


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--ic", default="plummer")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    pos, mass = staged_probe.inputs(args, dev)
    return probe(pos, mass, args, out=args.out)


if __name__ == "__main__":
    main()
