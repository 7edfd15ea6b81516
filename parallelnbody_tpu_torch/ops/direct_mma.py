"""The all-pairs sums on the tensor cores: K5, K6 and K7.

Counterpart of the three matrix-unit kernels of `scripts/mxu_allpairs.py`
(a TPU experiment; no path of the JAX package runs them), source
csrc/allpairs_mma.cu:

  * `allpairs_mma_v3` replaces `_kern_v3` (mxu_allpairs.py:41): w = m_j u^3
    formed from d = x_j - x_i on the FP32 pipes, the accumulation
    raw = W @ [x_j, y_j, z_j, 1] on the tensor cores;
  * `allpairs_mma_v1` replaces `_kern_v1` (:65): also
    r^2 = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) + eps^2, with the cross term
    x_i.x_j a tensor-core product;
  * `allpairs_mma_v4` replaces `_kern_v4` (:86): positions sorted along a
    Hilbert curve, each source j-tile of `tile_j` re-centred on its
    centroid c_j (raw += W @ [x_j - c_j, 1] + rowsum * c_j), and the tiles
    near the diagonal (the band) summed as w d on the FP32 pipes.

Each returns the raw sums (n, 4); `combine(raw, pos)` gives
acc = raw[:, :3] - raw[:, 3:4] * pos = sum_j w_ij (x_j - x_i), the
acceleration over g.

Precision. The TPU runs these products at `Precision.DEFAULT` (one bf16
pass) or `HIGHEST` (six passes, about f32). On the card:

  * precision=1: one TF32 pass. Each operand is rounded to TF32 as
    `cvt.rna.tf32.f32` does (`tf32_round`: to nearest, ties away from
    zero, on the f32 bits); products are exact, sums in f32. This is what
    JAX's DEFAULT means on an NVIDIA GPU.
  * precision=3: 3xTF32. Each operand x is split into big = tf32(x) and
    small = tf32(x - big), and three products are summed,
    small.big + big.small + big.big (small.small, ~2^-22 of the product,
    is dropped): the ~f32-grade tensor-core product, the role HIGHEST
    plays on the matrix unit.

Beside each wrapper is its plain PyTorch version (`*_plain`), which forms
the same operands and sums the same products in f32, tile by tile as the
script's grid does (`tile_i` x `tile_j`). Those two parameters belong to
the function, not to the kernel's own thread blocks: they decide V4's band
and centroids, and default to the script's 256 / 2048. One exception to
"sums in f32": V1's cross term is a difference of squares, where one unit
in the last place of |x|^2 moves r^2 near the diagonal by ~1e-3 relative,
so the plain version sums its three products as the tensor core does
(`tensor_core_step`).

The wrappers dispatch on the device of their tensors (kernels/launch.py):
CPU tensors run the plain version, CUDA tensors launch the kernel or raise.
f32 only; softening must be > 0 (the script's sums have no zero guard); V4
needs n a multiple of tile_j, tile_j a multiple of 8 and tile_i of 64.
`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.kernels.launch import (check, launch, on_cpu, ptr,
                                                    query)

LAUNCHES = {"allpairs_mma_v3": 0, "allpairs_mma_v1": 0, "allpairs_mma_v4": 0}
VARIANTS = {"v3": 3, "v1": 1, "v4": 4}
PRECISIONS = (1, 3)
TILE_I, TILE_J = 256, 2048   # scripts/mxu_allpairs.py TI, TJ
BAND_TILES = 1

# Element budget of one plain-version (target rows x tile_j) plane.
_PLAIN_BLOCK_ELEMS = 1 << 23


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tf32_round(x):
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 does: to the nearest
    value with 10 explicit mantissa bits, ties away from zero, the low 13
    bits of the result zero. Inf and NaN pass through."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, not {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # Sign and magnitude: adding half a TF32 unit to the magnitude bits
    # rounds it half away from zero, for either sign.
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_parts(x, precision):
    """The TF32 operand parts of x: (big,) at precision 1, (big, small)
    with small = tf32(x - big) at precision 3 (x - big is exact in f32)."""
    big = tf32_round(x)
    return (big,) if precision == 1 else (big, tf32_round(x - big))


def tf32_product(a, b, precision):
    """a @ b on TF32 parts, f32 sums: tf32(a) @ tf32(b), or at precision 3
    (small(a) @ big(b) + big(a) @ small(b)) + big(a) @ big(b), the kernel's
    order. Products of TF32 values are exact in f32."""
    pa, pb = tf32_parts(a, precision), tf32_parts(b, precision)
    if precision == 1:
        return pa[0] @ pb[0]
    return (pa[1] @ pb[0] + pa[0] @ pb[1]) + pa[0] @ pb[0]


def _round_toward_zero(x64):
    """f64 -> f32, rounded toward zero."""
    x32 = x64.to(torch.float32)
    over = x32.to(torch.float64).abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)),
                       x32)


_NO_EXPONENT = -1000  # a zero addend's: below every other


def _exponent_or_none(nonzero, e):
    return torch.where(nonzero, e, torch.full_like(e, _NO_EXPONENT))


def _exponent(x64, nonzero):
    """floor(log2 |x|) of f64 x where `nonzero`, else _NO_EXPONENT."""
    return _exponent_or_none(nonzero, torch.frexp(x64).exponent - 1)


def _power_of_two(e):
    """2^e in f64, exactly, from the exponent bits (e clamped to the normal
    range; a quantum below it only ever divides zeros)."""
    biased = torch.clamp(e.to(torch.int64), -1022, 1023) + 1023
    return (biased << 52).view(torch.float64)


def tensor_core_step(a, b, acc):
    """acc + a @ b.T for TF32 values a (R, k), b (C, k) and an f32
    accumulator acc (R, C), rounded as one TF32 mma.sync of Hopper rounds:
    the products are exact; each addend (every product, and acc) is cut
    toward zero to a multiple of 2^(E - 25), E the largest addend exponent
    (a product's exponent taken as the sum of its factors'); the cut
    addends are summed exactly and the sum rounded toward zero to f32. The
    card tests hold the V1 kernel, whose cross term is one to three such
    steps, to this bit for bit through its parity."""
    a64, b64, c64 = (x.to(torch.float64) for x in (a, b, acc))
    ea = torch.frexp(a64).exponent - 1
    eb = torch.frexp(b64).exponent - 1
    top = _exponent(c64, c64 != 0)
    prods = []
    for q in range(a.shape[1]):
        prod = a64[:, q, None] * b64[None, :, q]                   # (R, C)
        top = torch.maximum(top, _exponent_or_none(
            prod != 0, ea[:, q, None] + eb[None, :, q]))
        prods.append(prod)
    unit = _power_of_two(25 - top)     # 1 / quantum
    quantum = _power_of_two(top - 25)
    total = torch.trunc(c64 * unit) * quantum
    for prod in prods:
        total += torch.trunc(prod * unit) * quantum
    return _round_toward_zero(total)


def cross_product(a, b, precision):
    """V1's cross term a @ b.T for a (R, 3), b (C, 3), summed as the
    kernel's m16n8k4 products sum it (`tensor_core_step`): at precision 1
    one step on the TF32 parts; at precision 3 three chained steps,
    small.big, big.small, big.big."""
    pa, pb = tf32_parts(a, precision), tf32_parts(b, precision)
    pairs = [(0, 0)] if precision == 1 else [(1, 0), (0, 1), (0, 0)]
    acc = a.new_zeros((a.shape[0], b.shape[0]))
    for ia, ib in pairs:
        acc = tensor_core_step(pa[ia], pb[ib], acc)
    return acc


def squared_norms(pos):
    """|x|^2 (n,) in f32, summed x^2 + y^2 + z^2 left to right: V1's
    |x_i|^2 and |x_j|^2 (the wrapper hands these to the kernel)."""
    return (pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1]) \
        + pos[:, 2] * pos[:, 2]


def tile_centroids(pos, tile_j):
    """V4's centroids (n / tile_j, 4) [cx, cy, cz, 0] of each source
    j-tile, in f32 (the script's jnp.mean)."""
    n = pos.shape[0]
    c = pos.reshape(n // tile_j, tile_j, 3).mean(dim=1)
    return torch.cat([c, c.new_zeros((c.shape[0], 1))], dim=1).contiguous()


def combine(raw, pos):
    """acc (n, 3) = raw[:, :3] - raw[:, 3:4] * pos: the sums
    sum_j w_ij (x_j - x_i) from the raw (n, 4) of any variant."""
    return raw[:, :3] - raw[:, 3:4] * pos


def in_band(i_tile, j_tile, tile_i, tile_j, band_tiles):
    """V4's band test of the script: the i-tile and j-tile midpoints closer
    than tile_j / 2 + tile_i / 2 + band_tiles * tile_j."""
    row_mid = i_tile * tile_i + tile_i // 2
    col_mid = j_tile * tile_j + tile_j // 2
    return (row_mid - col_mid).abs() < (tile_j // 2 + tile_i // 2
                                        + band_tiles * tile_j)


def _check_args(variant, pos, mass, softening, precision, tile_i, tile_j,
                band_tiles):
    """Raise on what neither the kernel nor its plain version takes."""
    n = pos.shape[0] if pos.dim() == 2 else -1
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(f"allpairs_mma_{variant}: float32 only (pos "
                        f"{pos.dtype}, mass {mass.dtype})")
    if pos.dim() != 2 or pos.shape[1] != 3 or tuple(mass.shape) != (n,):
        raise ValueError(f"allpairs_mma_{variant}: pos (n, 3) and mass (n,), "
                         f"got {tuple(pos.shape)} and {tuple(mass.shape)}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: 1 (TF32) or 3 (3xTF32)")
    if not softening > 0:
        raise ValueError(f"softening {softening!r}: these sums need "
                         "softening > 0 (no zero guard, as in the script)")
    if tile_i <= 0 or tile_j <= 0 or band_tiles < 0:
        raise ValueError(f"tile_i {tile_i}, tile_j {tile_j}, band_tiles "
                         f"{band_tiles}: tiles > 0, band_tiles >= 0")
    if variant == "v4" and (n % tile_j or tile_j % 8 or tile_i % 64):
        raise ValueError(f"allpairs_mma_v4: n = {n} must be a multiple of "
                         f"tile_j = {tile_j}, tile_j of 8 and tile_i = "
                         f"{tile_i} of 64 (the band and centroids are per "
                         "tile; the kernel tests the band once for a warp's "
                         "64 targets)")


def _plain(variant, pos, mass, softening, precision, tile_i, tile_j,
           band_tiles):
    """The raw sums (n, 4) of one variant in plain torch, over blocks of
    whole i-tiles and one j-tile at a time, as the script's grid sums."""
    n = pos.shape[0]
    eps2 = float(softening) ** 2
    out = pos.new_zeros((n, 4))
    ones = pos.new_ones((n, 1))
    if variant == "v4":
        cj = tile_centroids(pos, tile_j)[:, :3]
        src = torch.cat([pos - cj.repeat_interleave(tile_j, dim=0), ones], 1)
    else:
        src = torch.cat([pos, ones], dim=1)
    n2 = squared_norms(pos) if variant == "v1" else None
    rows = tile_i * max(1, _PLAIN_BLOCK_ELEMS // (tile_i * tile_j))
    for i0 in range(0, n, rows):
        pi = pos[i0:i0 + rows]
        i_tile = (torch.arange(pi.shape[0], device=pos.device) + i0) // tile_i
        for jt, j0 in enumerate(range(0, n, tile_j)):
            pj, mj = pos[j0:j0 + tile_j], mass[j0:j0 + tile_j]
            if variant == "v1":
                cross = cross_product(pi, pj, precision)
                r2 = torch.clamp_min((n2[i0:i0 + rows, None]
                                      + n2[None, j0:j0 + tile_j])
                                     - 2.0 * cross, 0.0) + eps2
            else:
                d = pj[None, :, :] - pi[:, None, :]
                r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2]) + eps2
            u = torch.rsqrt(r2)
            w = (mj[None, :] * u) * (u * u)
            m = tf32_product(w, src[j0:j0 + tile_j], precision)
            if variant != "v4":
                out[i0:i0 + rows] += m
                continue
            band = in_band(i_tile, jt, tile_i, tile_j, band_tiles)[:, None]
            near = torch.einsum("ij,ijc->ic", w, d)
            far = torch.cat([m[:, :3] + m[:, 3:4] * cj[jt], m[:, 3:4]], 1)
            out[i0:i0 + rows] += torch.where(
                band, torch.cat([near, torch.zeros_like(m[:, 3:4])], 1), far)
    return out


def _kernel(variant, pos, mass, softening, precision, tile_i, tile_j,
            band_tiles):
    """Launch the kernel of `variant` on CUDA tensors: the source table
    (n, 4) [x, y, z, m], V1's |x|^2 or V4's centroids built here as the
    plain version builds them, the sources cut into the ranges of
    `pnb_allpairs_mma_splits` and added in range order."""
    n = pos.shape[0]
    check("pos", pos, torch.float32, (n, 3))
    check("mass", mass, torch.float32, (n,))
    code = VARIANTS[variant]
    table = torch.cat([pos, mass[:, None]], dim=1).contiguous()
    if variant == "v1":
        aux = squared_norms(pos).contiguous()
    elif variant == "v4":
        aux = tile_centroids(pos, tile_j)
    else:
        aux = table  # not read
    out = torch.empty((n, 4), dtype=torch.float32, device=pos.device)
    n_split = query("pnb_allpairs_mma_splits", n, code, precision) if n else 1
    partial = torch.empty((n_split if n_split > 1 else 0, n, 4),
                          dtype=torch.float32, device=pos.device)
    launch(LAUNCHES, f"allpairs_mma_{variant}", "pnb_allpairs_mma",
           ptr(table), ptr(aux), ptr(out), ptr(partial), n, n_split,
           float(softening) ** 2, code, precision, tile_i, tile_j,
           band_tiles)
    return out


def _run(variant, pos, mass, softening, precision, tile_i, tile_j,
         band_tiles):
    _check_args(variant, pos, mass, softening, precision, tile_i, tile_j,
                band_tiles)
    fn = _plain if on_cpu(pos, mass) else _kernel
    return fn(variant, pos, mass, softening, precision, tile_i, tile_j,
              band_tiles)


def allpairs_mma_v3_plain(pos, mass, *, softening, precision, tile_i=TILE_I,
                          tile_j=TILE_J):
    """V3's raw sums (n, 4) [W @ x, W @ y, W @ z, rowsum W] in plain torch."""
    _check_args("v3", pos, mass, softening, precision, tile_i, tile_j, 0)
    return _plain("v3", pos, mass, softening, precision, tile_i, tile_j, 0)


def allpairs_mma_v1_plain(pos, mass, *, softening, precision, tile_i=TILE_I,
                          tile_j=TILE_J):
    """V1's raw sums (n, 4) in plain torch (r^2 from the cross term)."""
    _check_args("v1", pos, mass, softening, precision, tile_i, tile_j, 0)
    return _plain("v1", pos, mass, softening, precision, tile_i, tile_j, 0)


def allpairs_mma_v4_plain(pos, mass, *, softening, precision, tile_i=TILE_I,
                          tile_j=TILE_J, band_tiles=BAND_TILES):
    """V4's raw sums (n, 4) in plain torch: off the band
    [W @ (x - c_j) + rowsum c_j, rowsum], in the band [sum w d, 0]."""
    _check_args("v4", pos, mass, softening, precision, tile_i, tile_j,
                band_tiles)
    return _plain("v4", pos, mass, softening, precision, tile_i, tile_j,
                  band_tiles)


def allpairs_mma_v3(pos, mass, *, softening, precision, tile_i=TILE_I,
                    tile_j=TILE_J):
    """K5: V3's raw sums (n, 4) of the particles (pos (n, 3), mass (n,))
    on themselves. CPU tensors run `allpairs_mma_v3_plain`; CUDA tensors
    launch the kernel."""
    return _run("v3", pos, mass, softening, precision, tile_i, tile_j, 0)


def allpairs_mma_v1(pos, mass, *, softening, precision, tile_i=TILE_I,
                    tile_j=TILE_J):
    """K6: V1's raw sums (n, 4), r^2 from the cross-term product."""
    return _run("v1", pos, mass, softening, precision, tile_i, tile_j, 0)


def allpairs_mma_v4(pos, mass, *, softening, precision, tile_i=TILE_I,
                    tile_j=TILE_J, band_tiles=BAND_TILES):
    """K7: V4's raw sums (n, 4) of Hilbert-sorted particles: re-centred
    j-tiles on the tensor cores, the band on the FP32 pipes."""
    return _run("v4", pos, mass, softening, precision, tile_i, tile_j,
                band_tiles)


WRAPPERS = {"v3": allpairs_mma_v3, "v1": allpairs_mma_v1,
            "v4": allpairs_mma_v4}
PLAIN = {"v3": allpairs_mma_v3_plain, "v1": allpairs_mma_v1_plain,
         "v4": allpairs_mma_v4_plain}
