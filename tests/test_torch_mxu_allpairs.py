"""K5, K6 and K7 (ops/direct_mma.py) on the CPU against the three
matrix-unit kernels of scripts/mxu_allpairs.py, and the TF32 arithmetic
the port's plain versions share with the kernels.

The script's `_kern_v3`, `_kern_v1` and `_kern_v4` are imported read-only
and run through `pl.pallas_call(..., interpret=True)` with the script's
BlockSpecs at `Precision.HIGHEST` (f32 on the CPU). The port's plain
versions run at precision 3 (3xTF32) on the same numpy-seeded inputs:
Hilbert-sorted Plummer, eps 0.01; V3 and V1 at N = 4096, V4 at N = 16384,
the script's tile_i = 256, tile_j = 2048.

Tolerances:
  * V3 and V4 raw sums: rtol 1e-5 of the value, plus 1e-6 of the row's
    scale s_i = sum_j w_ij (|x_j|_inf + |x_i|_inf + 1) where the terms of a
    sum cancel (V4's centred and band sums; the value can be far below
    its terms). 3xTF32 drops small.small, ~2^-22 of a product; f32 sums
    in another order add ~1e-7 of s_i a row.
  * V1 raw sums: r^2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j is a difference of
    squares, and the two packages round the cross term differently (3xTF32
    through the tensor core's sums against an f32 dot), by less than
    delta_ij = 2^-20 (|x_i|^2 + |x_j|^2): the raw sums may differ by what a
    change of r^2 within +-delta_ij moves the weights,
    sum_j (w(r^2 - delta) - w(r^2 + delta)) |S_j|, plus the V3 tolerance.
  * acc = raw[:, :3] - raw[:, 3:4] x: each package's rms error against the
    script's f64 `ref_f64` within 2x of the other's (the cancellation the
    TPU found sets it: ~1e-2 for V3 and V1, ~5e-7 for V4), and V4 below
    the all-pairs bound 1e-4.
  * precision 1 against precision 3 (no JAX counterpart: the JAX kernels'
    DEFAULT is f32 on the CPU): within 2^-9 of s_i (each TF32 operand is
    within 2^-11 of its value), V1 with its delta at 2^-9.
The kernels themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallelnbody_tpu_torch.ops import direct_mma
from parallelnbody_tpu_torch.tools import mxu_allpairs as tool

_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "mxu_allpairs.py"
_spec = importlib.util.spec_from_file_location("mxu_allpairs_script", _SCRIPT)
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)   # read-only: the TPU script's kernels

torch.set_num_threads(2)

EPS = script.EPS
TI, TJ = script.TI, script.TJ
HIGHEST = jax.lax.Precision.HIGHEST
N_V3_V1, N_V4 = 4096, 16384
RTOL, SCALE_TOL = 1e-5, 1e-6
V1_DELTA = 2.0 ** -20
RMS_FACTOR = 2.0
TF32_SCALE_TOL = 2.0 ** -9
_ROWS = 256   # target rows a block of the f64 sums (~100 MB at N = 16384)


def _spec(shape, index, space=pltpu.VMEM):
    return pl.BlockSpec(shape, index, memory_space=space)


def _jax_v3_v1(kern, pos, mass):
    """The script's run_variant packing and pallas_call, interpreted."""
    n = pos.shape[0]
    pos, mass = jnp.asarray(pos), jnp.asarray(mass)
    if kern is script._kern_v3:
        pi = jnp.concatenate([pos, jnp.zeros((n, 1), pos.dtype)], axis=1)
        ptj = jnp.concatenate([pos, mass[:, None]], axis=1).T
    else:
        n2 = jnp.sum(pos * pos, axis=1, keepdims=True)
        pi = jnp.concatenate([pos, n2], axis=1)
        ptj = jnp.concatenate([pos, n2, mass[:, None]], axis=1).T
    sj = jnp.concatenate([pos, jnp.ones((n, 1), pos.dtype)], axis=1)
    return np.asarray(pl.pallas_call(
        functools.partial(kern, eps2=EPS * EPS, precision=HIGHEST),
        out_shape=jax.ShapeDtypeStruct((n, 4), pos.dtype),
        grid=(n // TI, n // TJ),
        in_specs=[_spec((TI, 4), lambda i, j: (i, 0)),
                  _spec((ptj.shape[0], TJ), lambda i, j: (0, j)),
                  _spec((TJ, 4), lambda i, j: (j, 0))],
        out_specs=_spec((TI, 4), lambda i, j: (i, 0)),
        interpret=True)(pi, ptj, sj))


def _jax_v4(pos, mass):
    """The script's run_v4 packing and pallas_call, interpreted."""
    n = pos.shape[0]
    pos, mass = jnp.asarray(pos), jnp.asarray(mass)
    pi = jnp.concatenate([pos, jnp.zeros((n, 1), pos.dtype)], axis=1)
    ptj = jnp.concatenate([pos, mass[:, None]], axis=1).T
    cj = jnp.mean(pos.reshape(n // TJ, TJ, 3), axis=1)
    cj4 = jnp.concatenate([cj, jnp.zeros((n // TJ, 1), pos.dtype)], axis=1)
    sj = jnp.concatenate([pos - jnp.repeat(cj, TJ, axis=0),
                          jnp.ones((n, 1), pos.dtype)], axis=1)
    return np.asarray(pl.pallas_call(
        functools.partial(script._kern_v4, eps2=EPS * EPS, precision=HIGHEST,
                          band_tiles=direct_mma.BAND_TILES),
        out_shape=jax.ShapeDtypeStruct((n, 4), pos.dtype),
        grid=(n // TI, n // TJ),
        in_specs=[_spec((TI, 4), lambda i, j: (i, 0)),
                  _spec((4, TJ), lambda i, j: (0, j)),
                  _spec((TJ, 4), lambda i, j: (j, 0)),
                  _spec((8, 4), lambda i, j: (j // 8, 0), pltpu.SMEM)],
        out_specs=_spec((TI, 4), lambda i, j: (i, 0)),
        interpret=True)(pi, ptj, sj, cj4))


def _plummer_sorted(n):
    """numpy (pos, mass): the port's seeded Plummer ICs, Hilbert-sorted."""
    pos, mass = tool.plummer_sorted(n, "cpu")
    return pos.numpy().copy(), mass.numpy().copy()


def _row_terms(pos, mass, delta_rel):
    """In f64, over blocks of target rows: the row scales
    s_i = sum_j w_ij (|x_j|_inf + |x_i|_inf + 1), and (delta_rel not None)
    V1's bound sum_j (w(r^2 - delta) - w(r^2 + delta)) |S_j| (n, 4) with
    delta_ij = delta_rel (|x_i|^2 + |x_j|^2)."""
    p = torch.from_numpy(pos).to(torch.float64)
    m = torch.from_numpy(mass).to(torch.float64)
    n2 = torch.sum(p * p, dim=1)
    s_abs = torch.cat([p.abs(), torch.ones(len(p), 1, dtype=p.dtype)], 1)
    top = p.abs().amax(1)
    scale = torch.zeros(len(p), dtype=p.dtype)
    bound = torch.zeros(len(p), 4, dtype=p.dtype)
    for i0 in range(0, len(p), _ROWS):
        rows = slice(i0, i0 + _ROWS)
        d = p[None] - p[rows, None]
        r2 = torch.sum(d * d, dim=-1) + EPS * EPS
        w = m[None] * r2 ** -1.5
        scale[rows] = (w * (top[None] + top[rows, None] + 1)).sum(1)
        if delta_rel is not None:
            delta = delta_rel * (n2[rows, None] + n2[None])
            hi = m[None] * torch.clamp_min(r2 - delta, EPS * EPS) ** -1.5
            lo = m[None] * (r2 + delta) ** -1.5
            bound[rows] = (hi - lo) @ s_abs
    return scale.numpy(), bound.numpy()


@pytest.fixture(scope="module")
def small():
    """V3 / V1 inputs at N = 4096, the f64 reference, the row scales and
    V1's cross-term bounds at the JAX comparison's and precision 1's
    deltas."""
    pos, mass = _plummer_sorted(N_V3_V1)
    scale, v1_bound = _row_terms(pos, mass, V1_DELTA)
    _, v1_bound_p1 = _row_terms(pos, mass, TF32_SCALE_TOL)
    return dict(pos=pos, mass=mass, ref=script.ref_f64(pos, mass),
                scale=scale, v1_bound={3: v1_bound, 1: v1_bound_p1})


@pytest.fixture(scope="module")
def large():
    """V4 inputs at N = 16384, the f64 reference (the tool's, which
    test_tool_helpers_match_the_script holds to the script's, in smaller
    blocks) and the row scales."""
    pos, mass = _plummer_sorted(N_V4)
    scale, _ = _row_terms(pos, mass, None)
    ref = tool.ref_f64(torch.from_numpy(pos), torch.from_numpy(mass),
                       block=_ROWS).numpy()
    return dict(pos=pos, mass=mass, ref=ref, scale=scale)


@functools.lru_cache(maxsize=None)
def _plain(variant, precision, n):
    pos, mass = _plummer_sorted(n)
    return direct_mma.PLAIN[variant](
        torch.from_numpy(pos), torch.from_numpy(mass), softening=EPS,
        precision=precision).numpy()


def _inputs(variant, small, large):
    return large if variant == "v4" else small


def _jax(variant, data):
    if variant == "v4":
        return _jax_v4(data["pos"], data["mass"])
    kern = script._kern_v3 if variant == "v3" else script._kern_v1
    return _jax_v3_v1(kern, data["pos"], data["mass"])


@pytest.mark.parametrize("variant", ["v3", "v1", "v4"])
def test_plain_matches_the_script_kernel(small, large, variant):
    """Raw sums at precision 3 against the script's kernel at HIGHEST; the
    combined acc within the raw tolerance carried through the combination;
    and each one's acc rms against ref_f64 within 2x of the other's."""
    data = _inputs(variant, small, large)
    pos = data["pos"]
    want = _jax(variant, data)
    got = _plain(variant, 3, len(pos))
    allowed = RTOL * np.abs(want) + SCALE_TOL * data["scale"][:, None]
    if variant == "v1":
        allowed = allowed + data["v1_bound"][3]
    excess = np.abs(got - want) - allowed
    assert (excess <= 0).all(), (variant, float(excess.max()))
    acc_t = direct_mma.combine(torch.from_numpy(got),
                               torch.from_numpy(pos)).numpy()
    acc_j = want[:, :3] - want[:, 3:4] * pos
    # The raw tolerance carried through acc = raw[:, :3] - raw[:, 3:4] x
    # (plus the f32 rounding of that combination, 2^-23 of its terms).
    terms = np.abs(want[:, :3]) + np.abs(want[:, 3:4] * pos)
    carried = (allowed[:, :3] + allowed[:, 3:4] * np.abs(pos)
               + 2.0 ** -22 * terms)
    assert (np.abs(acc_t - acc_j) <= carried).all(), variant
    rms_t, _ = script.errs(acc_t, data["ref"])
    rms_j, _ = script.errs(acc_j, data["ref"])
    assert rms_t <= RMS_FACTOR * rms_j and rms_j <= RMS_FACTOR * rms_t, (
        variant, rms_t, rms_j)


def test_v4_precision3_within_the_allpairs_bound(large):
    """V4 at 3xTF32 is the one tensor-core variant inside the port's
    all-pairs rms limit (1e-4): re-centring removes the cancellation."""
    acc = direct_mma.combine(torch.from_numpy(_plain("v4", 3, N_V4)),
                             torch.from_numpy(large["pos"])).numpy()
    rms, _ = script.errs(acc, large["ref"])
    assert rms < 1e-4, rms


@pytest.mark.parametrize("variant", ["v3", "v1", "v4"])
def test_precision1_within_tf32_of_precision3(small, large, variant):
    """One TF32 pass moves each operand by 2^-11 of itself at most: the raw
    sums stay within 2^-9 of the row's scale of the 3xTF32 sums (V1 with
    its cross term's delta at 2^-9), and are not equal to them."""
    data = _inputs(variant, small, large)
    n = len(data["pos"])
    p1, p3 = _plain(variant, 1, n), _plain(variant, 3, n)
    allowed = TF32_SCALE_TOL * data["scale"][:, None]
    if variant == "v1":
        allowed = allowed + data["v1_bound"][1]
    assert (np.abs(p1 - p3) <= allowed).all(), variant
    assert not np.array_equal(p1, p3)


def test_tool_helpers_match_the_script(small):
    """The tool's Hilbert sort, f64 sum and errors are the script's."""
    g = np.random.default_rng(5)
    pos = g.standard_normal((2048, 3)).astype(np.float32)
    mass = g.uniform(0.5, 1.5, 2048).astype(np.float32)
    want_pos, want_mass = script.hsort(jnp.asarray(pos), jnp.asarray(mass))
    got_pos, got_mass = tool.hsort(torch.from_numpy(pos),
                                   torch.from_numpy(mass))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_mass.numpy(), np.asarray(want_mass))
    ref_t = tool.ref_f64(torch.from_numpy(small["pos"]),
                         torch.from_numpy(small["mass"])).numpy()
    np.testing.assert_allclose(ref_t, small["ref"], rtol=1e-12, atol=1e-12)
    acc = _plain("v3", 3, N_V3_V1)
    acc = direct_mma.combine(torch.from_numpy(acc),
                             torch.from_numpy(small["pos"]))
    got = tool.errs(acc, torch.from_numpy(small["ref"]))
    np.testing.assert_allclose(got, script.errs(acc.numpy(), small["ref"]),
                               rtol=1e-12)


def test_tool_counts_the_work_and_bound():
    """The bound's inputs at N = 262144: n^2 pairs, the MUFU floor
    16.41 ms for every variant, V4's band pairs counted from the tiles."""
    n = 262144
    floor = n * n / tool.MUFU_RATE * 1e3
    for _, v, p in tool.VARIANTS:
        w = tool.work(v, p, n)
        b = tool.bound(w)
        assert w["pairs"] == n * n and w["rsqrts"] == n * n
        assert b["mufu_floor_ms"] == pytest.approx(floor)
        assert b["bound_ms"] >= b["mufu_floor_ms"]
    assert floor == pytest.approx(16.41, abs=0.01)
    assert tool.bound(tool.work("v0", None, n))["bound_resource"] == "fp32"
    band = tool.work("v4", 3, n)["band_pairs"]
    tiles = sum(abs(i * TI + TI // 2 - (j * TJ + TJ // 2))
                < TJ // 2 + TI // 2 + TJ
                for i in range(n // TI) for j in range(n // TJ))
    assert band == tiles * TI * TJ


def test_tool_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tool.main(["--n-accuracy", "2048", "--n-throughput", "2048"])
    with pytest.raises(RuntimeError, match="measures the card"):
        tool.table(2048, 2048)


# ------------------------------------------------------------- TF32 bits

def _bits(values):
    return torch.tensor(np.array(values, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("case", [
    # (input bits, expected bits): to nearest, ties away from zero
    (0x3F801000, 0x3F802000),   # 1 + half a TF32 unit: tie, up
    (0xBF801000, 0xBF802000),   # its negative: tie, away from zero
    (0x3F803000, 0x3F804000),   # odd lower neighbour, tie: up (not even)
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3F801001, 0x3F802000),   # just above: up
    (0x3FFFF000, 0x40000000),   # carries into the exponent
    (0x7F7FF000, 0x7F800000),   # the largest finite: to infinity
    (0x7F800000, 0x7F800000),   # infinity stays
    (0x00000FFF, 0x00000000),   # a denormal below half a unit: zero
], ids=["tie", "tie-negative", "tie-odd", "below", "above", "carry",
        "overflow", "inf", "denormal"])
def test_tf32_round_bits(case):
    x, want = case
    got = direct_mma.tf32_round(_bits([x]).view(torch.float32))
    assert int(got.view(torch.int32)[0]) & 0xFFFFFFFF == want


def test_tf32_round_nearest_idempotent_and_nan():
    g = np.random.default_rng(3)
    x = torch.from_numpy((g.standard_normal(100000)
                          * 2.0 ** g.integers(-30, 30, 100000))
                         .astype(np.float32))
    r = direct_mma.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.equal(direct_mma.tf32_round(r), r)
    # the nearest TF32 value: the error is at most half a unit of x
    unit = torch.ldexp(torch.ones_like(x),
                       torch.frexp(x.abs()).exponent - 11)
    assert ((r.double() - x.double()).abs() <= unit.double() / 2).all()
    nan = torch.tensor([float("nan")])
    assert torch.isnan(direct_mma.tf32_round(nan)).all()
    big, small = direct_mma.tf32_parts(x, 3)
    assert torch.equal(big, r)
    assert (small.view(torch.int32) & 0x1FFF == 0).all()
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs().clamp_min(1e-300))
    assert float(rel.max()) <= 2.0 ** -21


def test_tensor_core_step_rounds_toward_zero():
    """Exact sums pass through; an addend below 25 bits of the largest is
    cut, and the sum is rounded toward zero, for either sign."""
    one = torch.tensor([[1.0, 2.0 ** -30, 0.0]])
    unit = torch.tensor([[1.0, 1.0, 0.0]])
    acc = torch.zeros(1, 1)
    assert float(direct_mma.tensor_core_step(one, unit, acc)) == 1.0
    assert float(direct_mma.tensor_core_step(-one, unit, acc)) == -1.0
    a = torch.tensor([[1.0, 2.0 ** -24, 0.0]])        # kept, then cut by RZ
    assert float(direct_mma.tensor_core_step(a, unit, acc)) == 1.0
    b = torch.tensor([[1.5, 0.25, 0.125]])
    ones = torch.ones(1, 3)
    assert float(direct_mma.tensor_core_step(b, ones, acc + 2.0)) == 3.875
    x = torch.tensor([[1.0 + 2.0 ** -10, 1.0 - 2.0 ** -10, 0.0]])
    got = direct_mma.tensor_core_step(x, x, acc)  # 2 + 2^-19 exactly
    assert float(got) == 2.0 + 2.0 ** -19


def test_cross_product_close_to_f32():
    g = np.random.default_rng(7)
    a = torch.from_numpy(g.standard_normal((64, 3)).astype(np.float32))
    b = torch.from_numpy(g.standard_normal((48, 3)).astype(np.float32))
    exact = a.double() @ b.double().T
    for precision, tol in ((3, 2.0 ** -20), (1, 2.0 ** -9)):
        got = direct_mma.cross_product(a, b, precision).double()
        size = a.double().abs() @ b.double().abs().T
        assert ((got - exact).abs() <= tol * size).all(), precision


# ------------------------------------------------------------- wrappers

def _pm(n=2048, seed=1):
    g = np.random.default_rng(seed)
    return (torch.from_numpy(g.standard_normal((n, 3)).astype(np.float32)),
            torch.from_numpy(g.uniform(0.5, 1.5, n).astype(np.float32) / n))


@pytest.mark.parametrize("variant", ["v3", "v1", "v4"])
def test_wrapper_runs_the_plain_version_on_the_cpu(variant):
    pos, mass = _pm()
    direct_mma.reset_launch_counts()
    kw = dict(softening=EPS, precision=3, tile_i=128, tile_j=512)
    got = direct_mma.WRAPPERS[variant](pos, mass, **kw)
    assert torch.equal(got, direct_mma.PLAIN[variant](pos, mass, **kw))
    assert got.shape == (2048, 4) and bool(torch.isfinite(got).all())
    assert all(v == 0 for v in direct_mma.LAUNCHES.values())


@pytest.mark.parametrize("variant", ["v3", "v1", "v4"])
def test_wrappers_refuse_what_the_kernels_do_not_take(variant):
    pos, mass = _pm()
    fn = direct_mma.WRAPPERS[variant]
    with pytest.raises(TypeError, match="float32 only"):
        fn(pos.double(), mass.double(), softening=EPS, precision=3)
    with pytest.raises(ValueError, match="precision"):
        fn(pos, mass, softening=EPS, precision=2)
    with pytest.raises(ValueError, match="softening"):
        fn(pos, mass, softening=0.0, precision=3)
    with pytest.raises(ValueError, match=r"pos \(n, 3\)"):
        fn(pos[:, :2], mass, softening=EPS, precision=3)


def test_v4_refuses_shapes_off_its_tiles():
    pos, mass = _pm(3000)
    with pytest.raises(ValueError, match="multiple of tile_j"):
        direct_mma.allpairs_mma_v4(pos, mass, softening=EPS, precision=3)
    pos, mass = _pm(2048)
    with pytest.raises(ValueError, match="multiple of tile_j"):
        direct_mma.allpairs_mma_v4(pos, mass, softening=EPS, precision=3,
                                   tile_i=200, tile_j=512)
    # V3 and V1 take any n
    got = direct_mma.allpairs_mma_v3(_pm(1000)[0], _pm(1000)[1],
                                     softening=EPS, precision=1)
    assert got.shape == (1000, 4)


def test_combine_is_the_accelerations_sum():
    pos, mass = _pm(512)
    raw = direct_mma.allpairs_mma_v3(pos, mass, softening=EPS, precision=3,
                                     tile_i=128, tile_j=256)
    d = pos.double()[None] - pos.double()[:, None]
    w = mass.double()[None] * (d.square().sum(-1) + EPS ** 2) ** -1.5
    want = torch.einsum("ij,ijc->ic", w, d)
    got = direct_mma.combine(raw, pos).double()
    scale = (w * (pos.double().abs().amax(1)[None] + 1)).sum(1, keepdim=True)
    assert ((got - want).abs() <= 1e-5 * scale).all()


def test_shapes_tool_rewrites_the_kernel_constants(monkeypatch):
    """tools/mxu_shapes.py builds each block shape from the kernel source
    with its constants replaced (the first shape is the source as it
    stands), and refuses to run without a card."""
    from parallelnbody_tpu_torch.kernels import build
    from parallelnbody_tpu_torch.tools import mxu_shapes

    src = (build.CSRC_DIR / "allpairs_mma.cu").read_text()
    assert mxu_shapes.shape_source(*mxu_shapes.SHAPES[0]) == src
    for warps, mt, min_blocks in mxu_shapes.SHAPES:
        got = mxu_shapes.shape_source(warps, mt, min_blocks)
        assert f"constexpr int WARPS = {warps};" in got
        assert f"constexpr int MT = {mt};" in got
        assert ("__launch_bounds__(THREADS, MIN_BLOCKS)" in got) == (
            min_blocks > 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        mxu_shapes.main([])
