"""K8 (ops/near_probe.py) on the CPU against the probe kernel of
scripts/near_kernel_probe.py, and against K1's plain near field.

The script's `make_kernel(mode, unroll)` is imported read-only and run
through `pl.pallas_call(..., interpret=True)` with the script's BlockSpecs
and grid (one call a table segment, summed in segment order, as its `main`
does), on numpy-seeded lists of G = 128 targets: 16 target leaves, ascending
front-packed lists of up to 24 of the 16 source leaves, rows whose counts
leave a tail in every trip size and rows with no entry in some segment.
The script's kernel reads a segment's table block by the list's leaf id,
which is right only in the first segment; it is fed segment-relative ids
(id - segment * rows), the form the port's kernel computes (as the shipped
K1 subtracts its segment base), so that both compute what the script means.

Tolerance: the same f32 terms summed in the script's order (each tile, then
into the carry, then the segments), the sums within a tile and the rsqrt
taken by another library: |port - script| <= 1e-5 of the row's scale, the
largest |value| of the target leaf's output. The same against
`bh_kernels.near_field_plain` (compute_pot=False, g = 1) on the port's own
lists for mode A over four segments.
"""

import importlib.util
from pathlib import Path

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallelnbody_tpu_torch.ops import bh_kernels, near_probe
from parallelnbody_tpu_torch.tools import near_kernel_probe as tool

_SCRIPT = (Path(__file__).resolve().parents[1] / "scripts"
           / "near_kernel_probe.py")
_spec = importlib.util.spec_from_file_location("near_kernel_probe_script",
                                               _SCRIPT)
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)   # read-only: the TPU script's kernel

torch.set_num_threads(2)

G, LEAVES, BUDGET = 128, 16, 24
EPS2 = 1e-4
RTOL = 1e-5
INT32_MAX = np.iinfo(np.int32).max


def _inputs(seed=0):
    """numpy (tgt_t (L, 4, G), table (L, 4, G), idx (L, B), valid (L, B)):
    targets are the source leaves' own particles, as in the near field."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(LEAVES, G, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, size=(LEAVES, G, 1)).astype(np.float32) \
        / (LEAVES * G)
    table = np.concatenate([pos, mass], axis=2).transpose(0, 2, 1)
    tgt_t = np.concatenate([pos, np.zeros_like(mass)], axis=2).transpose(
        0, 2, 1)
    counts = rng.integers(1, LEAVES + 1, LEAVES)
    counts[:3] = (1, 5, LEAVES)            # tails of every trip size
    idx = np.full((LEAVES, BUDGET), INT32_MAX, np.int32)
    for t, c in enumerate(counts):
        idx[t, :c] = np.sort(rng.choice(LEAVES, c, replace=False))
    idx[3, :2] = (0, 1)                    # no entry past segment 0
    idx[3, 2:] = INT32_MAX
    return (np.ascontiguousarray(tgt_t), np.ascontiguousarray(table), idx,
            idx != INT32_MAX)


def _script_bounds(idx, valid, rows):
    """The script's make_bnd (:118-124) in numpy."""
    bnds = [np.zeros(idx.shape[0], np.int32)]
    for s in range(1, idx.shape[0] // rows):
        bnds.append(np.sum(valid & (idx < s * rows), axis=1, dtype=np.int32))
    bnds.append(np.sum(valid, axis=1, dtype=np.int32))
    return np.stack(bnds, axis=1)


def _script_probe(mode, unroll, tgt_t, table, idx, valid, rows, n_comp):
    """The script's kernel in interpret mode over every segment, fed
    segment-relative ids, summed in segment order (its main's `f`), with
    64-bit types off as on the TPU (mode B's rem takes int32 operands)."""
    if n_comp == 8:
        table = np.concatenate([table, np.zeros_like(table)], axis=1)
    bnd = _script_bounds(idx, valid, rows)
    kern = script.make_kernel(mode, unroll)
    with jax.enable_x64(False):
        return np.asarray(_segments(kern, tgt_t, table, idx, valid, bnd,
                                    rows))


def _segments(kern, tgt_t, table, idx, valid, bnd, rows):
    n_leaves, n_comp, g = tgt_t.shape[0], table.shape[1], tgt_t.shape[2]
    out = jnp.zeros(tgt_t.shape, jnp.float32)
    for s in range(n_leaves // rows):
        rel = np.where(valid, idx - s * rows, idx).astype(np.int32)
        out = out + pl.pallas_call(
            functools.partial(kern, eps2=EPS2),
            out_shape=jax.ShapeDtypeStruct(tgt_t.shape, jnp.float32),
            grid=(n_leaves,),
            in_specs=[
                pl.BlockSpec((8, 2), lambda t: (t // 8, 0),
                             memory_space=pltpu.SMEM),
                pl.BlockSpec((8, idx.shape[1]), lambda t: (t // 8, 0),
                             memory_space=pltpu.SMEM),
                pl.BlockSpec((1, 4, g), lambda t: (t, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((rows, n_comp, g), lambda t: (0, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, 4, g), lambda t: (t, 0, 0),
                                   memory_space=pltpu.VMEM),
            interpret=True,
        )(jnp.asarray(bnd[:, s:s + 2]), jnp.asarray(rel),
          jnp.asarray(tgt_t), jnp.asarray(table[s * rows:(s + 1) * rows]))
    return out


def _assert_rows_close(got, want):
    """|got - want| <= RTOL of each target leaf's largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    err = np.abs(got - want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(err <= RTOL * scale + 1e-30), (err / scale).max()


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("unroll", [4, 8])
@pytest.mark.parametrize("mode", ["A", "B", "C", "E"])
def test_plain_matches_the_script_kernel(mode, unroll, segments):
    tgt_t, table, idx, valid = _inputs()
    rows = LEAVES // segments
    want = _script_probe(mode, unroll, tgt_t, table, idx, valid, rows, 4)
    got = near_probe.near_probe(
        torch.from_numpy(tgt_t), torch.from_numpy(table),
        torch.from_numpy(idx), torch.from_numpy(valid), mode=mode,
        unroll=unroll, rows_per_seg=rows, eps2=EPS2)
    _assert_rows_close(got.numpy(), want)
    assert not got[:, 3].any()


@pytest.mark.parametrize("segments", [2, 8])
def test_mode_f_matches_the_script_on_a_padded_table(segments):
    """F: the script's mode A on an (L, 8, G) table; the port packs the
    sources 8 floats apart."""
    tgt_t, table, idx, valid = _inputs(1)
    rows = LEAVES // segments
    want = _script_probe("A", 4, tgt_t, table, idx, valid, rows, 8)
    got = near_probe.near_probe(
        torch.from_numpy(tgt_t), torch.from_numpy(table),
        torch.from_numpy(idx), torch.from_numpy(valid), mode="A", unroll=4,
        rows_per_seg=rows, n_comp=8, eps2=EPS2)
    _assert_rows_close(got.numpy(), want)


def test_bounds_and_table_layout():
    tgt_t, table, idx, valid = _inputs()
    for rows in (16, 8, 4, 2):
        got = near_probe.probe_bounds(torch.from_numpy(idx),
                                      torch.from_numpy(valid), rows)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      _script_bounds(idx, valid, rows))
    t = torch.from_numpy(table)
    packed = near_probe.probe_table(t, 8)
    assert packed.shape == (LEAVES, G, 8) and packed.is_contiguous()
    assert torch.equal(packed[..., :4], t.transpose(1, 2))
    assert not packed[..., 4:].any()


def test_mode_a_equals_k1_on_the_ports_lists():
    """K8's plain mode A over four segments sums the pairs of K1's plain
    near field (compute_pot=False, g = 1) on the probe tool's lists."""
    L = tool.probe_lists(4096, "cpu", leaf=64)
    n_leaves, _, g = L["tgt_t"].shape
    acc, _ = bh_kernels.near_field_plain(
        L["pos_s"], L["mass_s"], L["tgt"], L["idx"], L["valid"], g=1.0,
        softening=tool.SOFTENING, compute_pot=False)
    want = acc.reshape(n_leaves, g, 3).transpose(1, 2)
    got = near_probe.near_probe(L["tgt_t"], L["table"], L["idx"],
                                L["valid"], mode="A", unroll=4,
                                rows_per_seg=n_leaves // 4)
    assert L["entries"] > n_leaves
    _assert_rows_close(got[:, :3].numpy(), want.numpy())


def test_wrappers_refuse_what_they_do_not_take():
    tgt_t, table, idx, valid = (torch.from_numpy(a) for a in _inputs())
    kw = dict(mode="A", unroll=4, rows_per_seg=4)
    with pytest.raises(ValueError, match="rows_per_seg"):
        near_probe.near_probe(tgt_t, table, idx, valid,
                              **{**kw, "rows_per_seg": 5})
    for bad in ({"mode": "D"}, {"unroll": 2}, {"n_comp": 6}):
        with pytest.raises(ValueError, match="mode"):
            near_probe.near_probe(tgt_t, table, idx, valid, **{**kw, **bad})
    with pytest.raises(TypeError, match="float32"):
        near_probe.near_probe(tgt_t.double(), table, idx, valid, **kw)


def test_tool_needs_the_card():
    with pytest.raises(RuntimeError, match="is_available"):
        tool.table(n=16384)
    with pytest.raises(SystemExit):
        tool.main(["--n", "16384"])


def test_rounds_alternate_their_order(monkeypatch):
    """measure.rounds_ms times the calls in order, then in reverse, then in
    order, and keeps each call's first warm-up output; spread gives min,
    median and max of a row's rounds."""
    from parallelnbody_tpu_torch.tools import measure

    seen = []

    def fake_timed(fn, iters):
        seen.append(fn())
        return f"{seen[-1]}{len(seen)}", float(len(seen))

    monkeypatch.setattr(measure, "timed", fake_timed)
    got, firsts = measure.rounds_ms({k: (lambda k=k: k) for k in "abc"}, 3,
                                    1)
    assert "".join(seen) == "abccbaabc"
    assert got == {"a": [1.0, 6.0, 7.0], "b": [2.0, 5.0, 8.0],
                   "c": [3.0, 4.0, 9.0]}
    assert firsts == {"a": "a1", "b": "b2", "c": "c3"}
    assert measure.spread(got["a"]) == {"ms_min": 1.0, "ms": 6.0,
                                        "ms_max": 7.0}


def test_answer_marks_a_difference_only_beyond_the_spread():
    times = {"A": [10.0, 10.4, 10.2], "B": [9.0, 9.1, 9.05],
             "C": [9.0, 9.3, 9.1]}
    ab = tool._diff(times, "A", "B")
    assert ab["median"] == pytest.approx(1.15)
    assert (ab["min"], ab["max"]) == pytest.approx((1.0, 1.3))
    assert ab["spread"] == pytest.approx(0.4) and ab["beyond_spread"]
    bc = tool._diff(times, "B", "C")
    assert bc["median"] == pytest.approx(-0.05)
    assert bc["spread"] == pytest.approx(0.3) and not bc["beyond_spread"]
