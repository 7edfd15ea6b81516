"""The matrix-unit all-pairs experiments of scripts/mxu_allpairs.py on the
card's tensor cores: accuracy against an f64 direct sum and throughput.

    python3 -m parallelnbody_tpu_torch.tools.mxu_allpairs
        [--n-accuracy 16384] [--n-throughput 262144] [--iters 10]
        [--out FILE]

Variants, in the script's order: V0 (K3, `direct_kernels.allpairs`,
compute_pot=False), then V3, V1 and V4 (K5, K6, K7 of ops/direct_mma.py),
each at precision 1 (one TF32 pass) and 3 (3xTF32). Positions are Plummer
(`init_simulation(SimConfig(n, ic="plummer", softening=0.01,
force="direct"))`) sorted along the Hilbert curve (V4's premise; the same
order for all), as the script sorts them.

  accuracy    at --n-accuracy, each variant's acc = sum_j w_ij (x_j - x_i)
              (`direct_mma.combine` of the raw sums) against the f64 direct
              sum on the card, blocked over targets as the script's
              ref_f64: rms and max relative error a row;
  throughput  at --n-throughput, ms of one call by CUDA events (the mean of
              --iters after a warm-up), pairs/s, the bound (`bound`) and
              share = bound / ms, and beside it the floor every variant
              shares: n^2 rsqrts over the MUFU rate.

Prints one JSON line a variant, carrying the card's name and power limit
as nvidia-smi gives them (and appends it to --out). Needs a CUDA device;
fails without one. chip_smoke.py runs `table` and reads its lines.
"""

from __future__ import annotations

import argparse
import sys

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import direct_kernels, direct_mma
from parallelnbody_tpu_torch.ops.bh import domain_cube
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode
from parallelnbody_tpu_torch.tools.measure import (FP32_FLOPS, HBM_BYTES,
                                                   ITERS, MUFU_RATE,
                                                   TF32_FLOPS, card, emit,
                                                   events_ms)

EPS = 0.01
N_ACCURACY = 16384
N_THROUGHPUT = 262144
REF_BLOCK = 2048            # target rows a block of the f64 direct sum

# FP32 operations a pair (an FMA as two) beside chip_smoke.py's
# FLOPS_MONOPOLE = 18 (d 3, r^2 6, w 3, sums 6), and one rsqrt each:
#   V3, V4 off the band: d 3, r^2 6, w 3; the sums on the tensor cores;
#   V1: |x_i|^2 + |x_j|^2 1, -2 x_i.x_j + that 2, max 1, + eps^2 1, w 3;
#   precision 3 adds w - big (the split of w) 1;
#   V4 in the band: K3's 18.
FLOPS_PAIR = {"v0": 18, "v3": 12, "v1": 8, "v4": 12}
FLOPS_SPLIT = 1
FLOPS_BAND = 18
# Tensor-core FLOPs a pair and pass: W @ [x, y, z, 1] 2 x 4; V1's cross
# term x_i . x_j 2 x 3 more. Times the passes (1 or 3).
TC_FLOPS_PAIR = {"v3": 8, "v1": 14, "v4": 8}

VARIANTS = [("V0 K3", "v0", None)] + [
    (f"{v.upper()} {'TF32' if p == 1 else '3xTF32'}", v, p)
    for v in ("v3", "v1", "v4") for p in direct_mma.PRECISIONS]


def hsort(pos, mass):
    """Sorted along the Hilbert curve of the bounding cube (the script's
    hsort)."""
    c, h, _ = domain_cube(torch.amin(pos, 0), torch.amax(pos, 0))
    order = torch.argsort(hilbert_encode(pos, c, h))
    return pos[order].contiguous(), mass[order].contiguous()


def plummer_sorted(n, device):
    state = init_simulation(SimConfig(n=n, ic="plummer", softening=EPS,
                                      force="direct"), device,
                            compute_forces=False)
    return hsort(state.pos, state.mass)


def ref_f64(pos, mass, block=REF_BLOCK):
    """acc_i = sum_j w_ij (x_j - x_i) in f64, blocked over targets."""
    p, m = pos.to(torch.float64), mass.to(torch.float64)
    acc = torch.zeros_like(p)
    for i0 in range(0, p.shape[0], block):
        d = p[None, :, :] - p[i0:i0 + block, None, :]
        w = m[None, :] * (torch.sum(d * d, dim=-1) + EPS * EPS) ** -1.5
        acc[i0:i0 + block] = torch.einsum("bj,bjc->bc", w, d)
    return acc


def errs(acc, ref):
    """(rms, max) of the relative error a row, |acc - ref| / |ref|."""
    e = (torch.linalg.norm(acc.to(torch.float64) - ref, dim=1)
         / torch.linalg.norm(ref, dim=1).clamp_min(1e-300))
    return float(torch.sqrt(torch.mean(e * e))), float(torch.max(e))


def accel(variant, precision, pos, mass):
    """acc (n, 3) of one variant (V0 through K3)."""
    if variant == "v0":
        return direct_kernels.allpairs(pos, pos, mass, softening=EPS,
                                       compute_pot=False)[:, :3]
    raw = direct_mma.WRAPPERS[variant](pos, mass, softening=EPS,
                                       precision=precision)
    return direct_mma.combine(raw, pos)


def band_pairs(n, tile_i=direct_mma.TILE_I, tile_j=direct_mma.TILE_J,
               band_tiles=direct_mma.BAND_TILES):
    """V4's pairs in band tiles (summed on the FP32 pipes) at n."""
    it = torch.arange(n // tile_i)[:, None]
    jt = torch.arange(n // tile_j)[None, :]
    tiles = direct_mma.in_band(it, jt, tile_i, tile_j, band_tiles)
    return int(tiles.sum()) * tile_i * tile_j


def work(variant, precision, n):
    """What one call needs at n: pairs, FP32 operations, rsqrts,
    tensor-core FLOPs and bytes (the table and output, moved once)."""
    pairs = n * n
    band = band_pairs(n) if variant == "v4" else 0
    split = FLOPS_SPLIT if precision == 3 else 0
    fp32 = (pairs - band) * (FLOPS_PAIR[variant] + split) + band * FLOPS_BAND
    tc = (0 if variant == "v0" else
          (pairs - band) * TC_FLOPS_PAIR[variant] * precision)
    extra = {"v1": 4 * n, "v4": 16 * (n // direct_mma.TILE_J)}.get(variant, 0)
    return {"pairs": pairs, "band_pairs": band, "fp32_ops": fp32,
            "rsqrts": pairs, "tc_flops": tc, "bytes": 32 * n + extra}


def bound(w):
    """The least time for the work w: bound_ms, bound_by ("operations" or
    "bytes"), the resource that sets it, and the MUFU floor (n^2 rsqrts
    over the MUFU rate) every variant shares."""
    secs = {"fp32": w["fp32_ops"] / FP32_FLOPS, "mufu": w["rsqrts"] / MUFU_RATE,
            "tensor": w["tc_flops"] / TF32_FLOPS,
            "hbm": w["bytes"] / HBM_BYTES}
    res = max(secs, key=secs.get)
    return {"bound_ms": secs[res] * 1e3,
            "bound_by": "bytes" if res == "hbm" else "operations",
            "bound_resource": res, "mufu_floor_ms": secs["mufu"] * 1e3}


def table(n_accuracy=N_ACCURACY, n_throughput=N_THROUGHPUT, iters=ITERS,
          out=None):
    """Runs every variant's accuracy and throughput; prints and returns one
    record a variant."""
    if not torch.cuda.is_available():
        raise RuntimeError("mxu_allpairs measures the card: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = card()
    pos, mass = plummer_sorted(n_accuracy, dev)
    ref = ref_f64(pos, mass)
    accuracy = {}
    for name, v, p in VARIANTS:
        acc = accel(v, p, pos, mass)
        if not bool(torch.isfinite(acc).all()):
            raise AssertionError(f"{name}: non-finite acc at n={n_accuracy}")
        accuracy[name] = errs(acc, ref)
    del pos, mass, ref
    pos, mass = plummer_sorted(n_throughput, dev)
    records = []
    for name, v, p in VARIANTS:
        ms = events_ms(lambda: accel(v, p, pos, mass), iters)
        rec = {"variant": name, "kernel": v, "precision": p,
               "n_accuracy": n_accuracy, "rms_err": accuracy[name][0],
               "max_err": accuracy[name][1], "n": n_throughput, "ms": ms,
               "pairs_per_s": n_throughput ** 2 / (ms * 1e-3),
               **work(v, p, n_throughput)}
        rec.update(bound(rec))
        rec["share"] = rec["bound_ms"] / ms
        rec["floor_share"] = rec["mufu_floor_ms"] / ms
        rec["card"] = smi
        emit(rec, out)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-accuracy", type=int, default=N_ACCURACY)
    ap.add_argument("--n-throughput", type=int, default=N_THROUGHPUT)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mxu_allpairs: torch.cuda.is_available() is False; this "
                 "tool measures the card")
    table(opts.n_accuracy, opts.n_throughput, opts.iters, opts.out)


if __name__ == "__main__":
    main()
