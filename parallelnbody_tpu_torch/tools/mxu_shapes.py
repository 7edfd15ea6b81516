"""Block shapes of the tensor-core all-pairs kernels K5-K7
(csrc/allpairs_mma.cu), timed on the card: how their constants were chosen.

    python3 -m parallelnbody_tpu_torch.tools.mxu_shapes [--out FILE]

For each shape (WARPS warps a block, MT m16 tiles of targets a warp,
MIN_BLOCKS in the kernel's launch bounds, 0 for none) the source is
compiled with those constants replaced, by nvcc with the library's flags,
into a library of its own under build/kernels/shapes/ (all shapes at
once); ptxas's registers and spills are kept. Each shape's six kernels
(V3, V1, V4 at precision 1 and 3) are held against their plain versions at
N = 16384 (rtol 2e-4 / atol 2e-5, Hilbert-sorted Plummer) and timed at
N = 262144 (CUDA events, the mean of 10 launches after a warm-up, the
source ranges of each shape's own pnb_allpairs_mma_splits), beside K3.
Prints one JSON line a shape with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from parallelnbody_tpu_torch.kernels import build
from parallelnbody_tpu_torch.ops import direct_mma
from parallelnbody_tpu_torch.tools import mxu_allpairs

# (WARPS, MT, MIN_BLOCKS); the first is the source as it stands.
SHAPES = [(8, 4, 2), (8, 4, 0), (8, 4, 3), (8, 2, 0), (8, 2, 3), (8, 2, 4),
          (8, 1, 4), (4, 4, 4), (4, 4, 6), (4, 2, 8)]
SHAPE_DIR = build.BUILD_DIR / "shapes"
RTOL, ATOL = 2e-4, 2e-5
KERNELS = [(v, p) for v in ("v3", "v1", "v4") for p in direct_mma.PRECISIONS]


def shape_source(warps, mt, min_blocks):
    src = (build.CSRC_DIR / "allpairs_mma.cu").read_text()
    for old, new in (("constexpr int WARPS = 8;",
                      f"constexpr int WARPS = {warps};"),
                     ("constexpr int MT = 4;", f"constexpr int MT = {mt};"),
                     ("constexpr int MIN_BLOCKS = 2;",
                      f"constexpr int MIN_BLOCKS = {max(min_blocks, 1)};")):
        if old not in src:
            raise RuntimeError(f"csrc/allpairs_mma.cu has no {old!r}")
        src = src.replace(old, new)
    if min_blocks == 0:
        src = src.replace("__launch_bounds__(THREADS, MIN_BLOCKS)",
                          "__launch_bounds__(THREADS)")
    return src


def compile_shape(shape):
    """(shape, library path, ptxas usage lines); raises on a failed build."""
    tag = "w{}_mt{}_mb{}".format(*shape)
    SHAPE_DIR.mkdir(parents=True, exist_ok=True)
    cu = SHAPE_DIR / f"{tag}.cu"
    so = SHAPE_DIR / f"{tag}.so"
    cu.write_text(shape_source(*shape))
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC_DIR), "-shared", "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{r.stdout}{r.stderr}")
    usage = [line.split(":", 1)[-1].strip()
             for line in (r.stdout + r.stderr).splitlines()
             if "allpairs_mma_kernel" in line or "Used" in line
             or "spill" in line]
    return shape, so, usage


def load(so):
    lib = ctypes.CDLL(str(so))
    for name, argtypes, restype in build._SIGNATURES:
        if name.startswith("pnb_allpairs_mma"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def launcher(lib, variant, precision, pos, mass):
    """fn() launching one shape's kernel as direct_mma's wrapper does."""
    n, code = pos.shape[0], direct_mma.VARIANTS[variant]
    table = torch.cat([pos, mass[:, None]], dim=1).contiguous()
    aux = (direct_mma.squared_norms(pos).contiguous() if variant == "v1"
           else direct_mma.tile_centroids(pos, direct_mma.TILE_J)
           if variant == "v4" else table)
    n_split = lib.pnb_allpairs_mma_splits(n, code, precision)
    if n_split < 1:
        raise RuntimeError(f"pnb_allpairs_mma_splits: {n_split}")
    out = torch.empty((n, 4), device=pos.device)
    partial = torch.empty((n_split if n_split > 1 else 0, n, 4),
                          device=pos.device)

    def fn():
        err = lib.pnb_allpairs_mma(
            table.data_ptr(), aux.data_ptr(), out.data_ptr(),
            partial.data_ptr(), n, n_split, mxu_allpairs.EPS ** 2, code,
            precision, direct_mma.TILE_I, direct_mma.TILE_J,
            direct_mma.BAND_TILES, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pnb_allpairs_mma: CUDA error {err}")
        return out

    return fn, n_split


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mxu_shapes: torch.cuda.is_available() is False; this tool "
                 "times the card")
    with ThreadPoolExecutor(len(SHAPES)) as ex:
        built = list(ex.map(compile_shape, SHAPES))
    dev = torch.device("cuda")
    card = mxu_allpairs.card()
    small = mxu_allpairs.plummer_sorted(mxu_allpairs.N_ACCURACY, dev)
    plain = {(v, p): direct_mma.PLAIN[v](*small, softening=mxu_allpairs.EPS,
                                         precision=p) for v, p in KERNELS}
    big = mxu_allpairs.plummer_sorted(mxu_allpairs.N_THROUGHPUT, dev)
    k3 = mxu_allpairs.events_ms(lambda: mxu_allpairs.accel("v0", None, *big))
    for (warps, mt, min_blocks), so, usage in built:
        lib = load(so)
        rec = {"warps": warps, "mt": mt, "min_blocks": min_blocks,
               "ptxas": usage, "k3_ms": k3}
        for v, p in KERNELS:
            got = launcher(lib, v, p, *small)[0]().clone()
            want = plain[(v, p)]
            bad = int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())
            if bad:
                raise AssertionError(f"shape {warps}x{mt}x{min_blocks} {v} "
                                     f"precision {p}: {bad} values off")
            fn, n_split = launcher(lib, v, p, *big)
            rec[f"{v}_p{p}_ms"] = mxu_allpairs.events_ms(fn)
            rec[f"{v}_p{p}_splits"] = n_split
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        if opts.out:
            with open(opts.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
