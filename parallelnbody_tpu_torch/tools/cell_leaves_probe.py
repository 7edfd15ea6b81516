"""Cell-aligned (radius-bounded) leaf groups against equal-count leaves on
one CUDA device: the port of scripts/cell_leaves_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.cell_leaves_probe
        [--n 1048576] [--g 256] [--theta 0.72] [--iters 5]
        [--device cuda] [--out FILE]

Equal-count Hilbert leaves in sparse regions have large bounding radii, so
their group MAC makes them near nearly everything. The Cornerstone-style
alternative: a leaf is the coarsest octree cell (a Hilbert key prefix)
holding <= G particles, optionally refined to a depth floor d_floor, so its
radius is bounded by its cell. For the same particles this tool gives each
structure's near-list statistics (leaf fills, radius percentiles, near
entries a target) and its predicted near work:

  * padded tiles = near list entries, each G x G pairs: what K1 executes;
  * true pairs = sum over near pairs of fill_t x fill_s (f64): what an
    ideal CSR kernel executes.

The script converted them at the TPU's rates (its near kernel and
flat_kernel_tune2's CSR kernel). Here both rates are the card's, measured
in the same run on the equal-count leaves' own near lists
(`near_rates.rates`): K1, and K11 "row" on the lists' flat form
(`near_flat.pack_lists`); padded_ms = tiles x G^2 / K1's rate, true_ms =
true pairs / K11's. On the CPU both rates, and so both estimates, are
null.

Inputs: the Plummer positions and masses of `SimConfig(n, ic="plummer")`
from its seed (`staged_probe.inputs`; the script drew them with JAX's key
0, the port's generator is seeded by the config's seed); the port's
`hilbert_encode` on
`domain_cube` of the bounding box, a stable sort. The script ran on the
host in numpy with JAX pinned to the CPU; here the per-depth cell counts
are `torch.unique` (inverse and counts), the leaf CoMs `index_add_`
(on the card its float atomics may round a CoM differently from run to
run) and the radii `scatter_reduce("amax")`, all on the device. Each
structure's `leaf_stats` has its events ms and busy ms (`measure.phase`).
`--device cpu` (the tests) times nothing. Every line is one JSON object
carrying the card's name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parallelnbody_tpu_torch.ops.bh import MAC_SIZE_SCALE, domain_cube
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode
from parallelnbody_tpu_torch.ops.morton import MORTON_BITS
from parallelnbody_tpu_torch.tools import measure, near_rates, staged_probe

D_FLOORS = (0, 3, 4, 5)
MASK_ELEMS = 1 << 27        # the script's row block: (block, L) planes


def leaf_moments(starts, ends, pos_s, mass_s):
    """(com (L, 3) f32, radius (L,) f32) of the runs [starts, ends) of the
    sorted particles."""
    n_leaves = starts.shape[0]
    fills = ends - starts
    leaf_of = torch.repeat_interleave(
        torch.arange(n_leaves, device=pos_s.device), fills)
    mw = torch.zeros(n_leaves, dtype=mass_s.dtype,
                     device=mass_s.device).index_add_(0, leaf_of, mass_s)
    com = torch.zeros((n_leaves, 3), dtype=pos_s.dtype, device=pos_s.device)
    for c in range(3):
        s = torch.zeros_like(mw).index_add_(0, leaf_of,
                                            mass_s * pos_s[:, c])
        com[:, c] = s / torch.clamp(mw, min=1e-30)
    d = torch.sqrt(torch.sum((pos_s - com[leaf_of]) ** 2, dim=1))
    rad = torch.zeros(n_leaves, dtype=pos_s.dtype,
                      device=pos_s.device).scatter_reduce(
        0, leaf_of, d, "amax")
    return com, rad


def near_rows(com, rad, theta, r0, r1):
    """The near mask of target leaves [r0, r1) against every leaf."""
    d2 = torch.zeros((r1 - r0, com.shape[0]), dtype=com.dtype,
                     device=com.device)
    for c in range(3):
        dc = com[None, :, c] - com[r0:r1, None, c]
        d2 = d2 + dc * dc
    return (MAC_SIZE_SCALE * rad[None, :]) >= (
        theta * (torch.sqrt(d2) - rad[r0:r1, None]))


def leaf_stats(starts, ends, pos_s, mass_s, theta, keep_mask=False):
    """One structure's statistics: {"n_leaves", "fills", "radius",
    "counts" (near entries a target, numpy), "tiles", "true_pairs"}; with
    keep_mask also "near" (L, L)."""
    n_leaves = starts.shape[0]
    fills = ends - starts
    com, rad = leaf_moments(starts, ends, pos_s, mass_s)
    counts = torch.zeros(n_leaves, dtype=torch.int64, device=pos_s.device)
    true_pairs = 0.0
    block = max(256, MASK_ELEMS // max(n_leaves, 1))
    fills_f = fills.to(torch.float64)
    masks = []
    for r0 in range(0, n_leaves, block):
        r1 = min(r0 + block, n_leaves)
        near = near_rows(com, rad, theta, r0, r1)
        counts[r0:r1] = near.sum(1)
        true_pairs += float((near.to(torch.float64) @ fills_f)
                            @ fills_f[r0:r1])
        if keep_mask:
            masks.append(near)
    out = {"n_leaves": n_leaves, "fills": fills.cpu().numpy(),
           "radius": rad.cpu().numpy(), "counts": counts.cpu().numpy(),
           "tiles": int(counts.sum()), "true_pairs": true_pairs}
    if keep_mask:
        out["near"] = torch.cat(masks)
    return out


def leaf_depths(keys_s, g, bits=MORTON_BITS):
    """Each sorted particle's leaf depth: the coarsest depth whose cell
    (key prefix) holds <= g particles."""
    leaf_depth = torch.full(keys_s.shape, bits, dtype=torch.int8,
                            device=keys_s.device)
    done = torch.zeros(keys_s.shape, dtype=torch.bool, device=keys_s.device)
    for d in range(0, bits + 1):
        cid = keys_s >> (3 * (bits - d))
        _, inv, cnt = torch.unique(cid, return_inverse=True,
                                   return_counts=True)
        ok = (cnt[inv] <= g) & ~done
        leaf_depth[ok] = d
        done |= ok
        if bool(done.all()):
            break
    return leaf_depth


def cell_runs(keys_s, leaf_depth, d_floor, bits=MORTON_BITS):
    """(starts, ends) of the cell-aligned leaves at depth floor d_floor:
    runs of equal (cell id, depth) tags, contiguous in sorted order."""
    n = keys_s.shape[0]
    dd = torch.clamp(leaf_depth.to(torch.int64), min=d_floor)
    cid = keys_s.to(torch.int64) >> (3 * (bits - dd))
    tag = cid * (bits + 1) + dd
    change = torch.ones(n, dtype=torch.bool, device=keys_s.device)
    change[1:] = tag[1:] != tag[:-1]
    starts = torch.nonzero(change).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    return starts, ends


def _q(a, p):
    return float(np.percentile(a, p))


def _record(name, st, g, rate):
    fills, rad, counts = st["fills"], st["radius"], st["counts"]
    k1 = rate["k1_pairs_per_s"]
    csr = rate["k11_pairs_per_s"]
    return {"structure": name, "n_leaves": st["n_leaves"],
            "fill": {"mean": float(fills.mean()), "p10": _q(fills, 10),
                     "p50": _q(fills, 50)},
            "radius": {"p50": _q(rad, 50), "p99": _q(rad, 99),
                       "max": float(rad.max())},
            "near_per_target": {"mean": float(counts.mean()),
                                "p99": _q(counts, 99),
                                "max": int(counts.max())},
            "tiles": st["tiles"], "padded_pairs": st["tiles"] * g * g,
            "padded_ms": near_rates.ms_eq(st["tiles"] * g * g, k1),
            "true_pairs": st["true_pairs"],
            "true_ms": near_rates.ms_eq(st["true_pairs"], csr)}


def probe(pos, mass, args, out=None):
    """The script's structures on pos / mass (on their device); emits and
    returns the records: the rates, then one a structure."""
    dev = pos.device
    n, g = pos.shape[0], args.g
    lo, hi = torch.amin(pos, 0), torch.amax(pos, 0)
    center, half, sentinel = domain_cube(lo, hi)
    keys = hilbert_encode(pos, center, half)
    order = torch.sort(keys, stable=True).indices
    keys_s, pos_s, mass_s = keys[order], pos[order], mass[order]
    base = {"tool": "cell_leaves_probe", "card": measure.card_of(dev),
            "n": n, "g": g, "theta": args.theta, "bits": MORTON_BITS}
    records = []

    def stats(starts, ends, keep_mask=False):
        return measure.phase(lambda: leaf_stats(
            starts, ends, pos_s, mass_s, args.theta, keep_mask),
            args.iters, dev)

    # ---- equal-count leaves (the shipped design)
    n_eq = -(-n // g)
    starts = torch.arange(n_eq, device=dev) * g
    ends = torch.clamp(starts + g, max=n)
    eq, eq_times = stats(starts, ends, keep_mask=True)
    pad = n_eq * g - n
    pos_p = torch.cat([pos_s, sentinel.expand(pad, 3)])
    mass_p = torch.cat([mass_s, mass_s.new_zeros(pad)])
    rate = near_rates.rates(pos_p, mass_p, eq.pop("near"), args.iters,
                            k11=True)
    del pos_p, mass_p
    records.append({**base, **rate})
    measure.emit(records[-1], out)
    records.append({**base, **_record("equal-count", eq, g, rate),
                    **eq_times})
    measure.emit(records[-1], out)

    # ---- cell-aligned: leaf = coarsest cell with count <= G, with an
    # optional depth floor
    depth, depth_times = measure.phase(lambda: leaf_depths(keys_s, g),
                                       args.iters, dev)
    for d_floor in D_FLOORS:
        starts, ends = cell_runs(keys_s, depth, d_floor)
        st, times = stats(starts, ends)
        records.append({**base, **_record(f"cell d_floor={d_floor}", st, g,
                                          rate), **times,
                        "leaf_depth_ms": depth_times["ms"]})
        measure.emit(records[-1], out)
    return records


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--g", type=int, default=256)
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    args.ic = "plummer"
    pos, mass = staged_probe.inputs(args, dev)
    return probe(pos, mass, args, out=args.out)


if __name__ == "__main__":
    main()
