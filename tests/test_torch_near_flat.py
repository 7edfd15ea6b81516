"""K9, K10 and K11 (ops/near_flat.py) on the CPU against the flat-list
kernels of scripts/flat_kernel_proto.py, flat_kernel_tune.py and
flat_kernel_tune2.py, and against K1's plain near field.

The scripts are imported read-only. K9 runs the proto's own
`flat_near(..., interpret=True)`; the tune scripts' `run` has no interpret
flag, so the test builds their `pallas_call` (grid spec, BlockSpecs,
scratch, and the "steps" mode's segment_sum) around each script's
`make_kernel`, with interpret=True. Inputs are numpy-seeded at G = 128:
rows of 1 to 3 steps, the first row with one step and the last with
several, masses positive (as the proto's correctness check makes them);
guard_zero runs at eps2 = 0 with a source on a target.

Tolerance: the same f32 terms summed in the script's order (packs over
their 128 sources, then into the step, then into the row; or per lane
across packs and steps, then over the lanes), the sums over a pack's or a
lane's sources and the rsqrt taken by another library: |port - script| <=
1e-5 of the row's scale, the largest |value| of the target row's output.
The same against `bh_kernels.near_field_plain` (eps 0.01, with the
potential, g = 1) for K1's lists cut into the flat form.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallelnbody_tpu_torch.ops import bh_kernels, near_flat
from parallelnbody_tpu_torch.tools import flat_kernel
from parallelnbody_tpu_torch.tools import near_kernel_probe as probe


def _load(name):
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # read-only: the TPU script's kernel
    return mod


proto = _load("flat_kernel_proto")
tune = _load("flat_kernel_tune")
tune2 = _load("flat_kernel_tune2")

torch.set_num_threads(2)

G = 128
RTOL = 1e-5
STEPS_PER_ROW = [1, 3, 2, 1, 2, 3]


def _inputs(packs, seed=0, overlap=False):
    """numpy (rows, tgt_t (Ls, 4, G), src (S, P, 4, 128)); overlap puts
    one source on one target (r^2 = 0 at eps2 = 0)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(STEPS_PER_ROW)),
                     STEPS_PER_ROW).astype(np.int32)
    tgt_t = rng.normal(size=(len(STEPS_PER_ROW), 4, G)).astype(np.float32)
    src = rng.normal(size=(rows.shape[0], packs, 4, 128)).astype(np.float32)
    src[:, :, 3] = np.abs(src[:, :, 3])
    if overlap:
        src[2, 0, :3, 5] = tgt_t[rows[2], :3, 7]
    return rows, tgt_t, src


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_rows_close(got, want):
    """|got - want| <= RTOL of each target row's largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    err = np.abs(got - want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(err <= RTOL * scale + 1e-30), (err / scale).max()


def _script_grid(kernel, rows, tgt_t, src, out_rows, scratch=()):
    """The tune scripts' `run` pallas_call around `kernel`, interpreted."""
    n_steps, packs = src.shape[:2]
    g = tgt_t.shape[2]
    out_index = ((lambda c, rows: (rows[c], 0, 0)) if out_rows
                 else (lambda c, rows: (c, 0, 0)))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n_steps,),
        in_specs=[
            pl.BlockSpec((1, 4, g), lambda c, rows: (rows[c], 0, 0)),
            pl.BlockSpec((1, packs, 4, 128), lambda c, rows: (c, 0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 4, g), out_index),
        scratch_shapes=list(scratch),
    )
    n_out = tgt_t.shape[0] if out_rows else n_steps
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((n_out, 4, g), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(rows), jnp.asarray(tgt_t), jnp.asarray(src))


@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("guard_zero", [False, True])
def test_k9_matches_the_proto_kernel(guard_zero, compute_pot):
    rows, tgt_t, src = _inputs(near_flat.PROTO_PACKS, overlap=guard_zero)
    eps2 = 0.0 if guard_zero else 1e-2
    want = proto.flat_near(jnp.asarray(rows), jnp.asarray(tgt_t),
                           jnp.asarray(src), eps2=eps2, guard_zero=guard_zero,
                           compute_pot=compute_pot, interpret=True)
    got = near_flat.flat_near(*_torch(rows, tgt_t, src), eps2=eps2,
                              guard_zero=guard_zero, compute_pot=compute_pot)
    _assert_rows_close(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()
    if not compute_pot:
        assert not got[:, 3].any()


@pytest.mark.parametrize("out_mode", ["rmw", "steps"])
@pytest.mark.parametrize("packs", [4, 8, 16])
def test_k10_matches_the_tune_kernel(packs, out_mode):
    rows, tgt_t, src = _inputs(packs, seed=packs)
    want = _script_grid(tune.make_kernel(packs, out_mode), rows, tgt_t, src,
                        out_rows=out_mode == "rmw")
    if out_mode == "steps":
        want = jax.ops.segment_sum(want, jnp.asarray(rows),
                                   num_segments=tgt_t.shape[0])
    got = near_flat.flat_tune(*_torch(rows, tgt_t, src), step_packs=packs,
                              out_mode=out_mode)
    _assert_rows_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["step", "row"])
@pytest.mark.parametrize("packs", [4, 8, 16])
def test_k11_matches_the_tune2_kernel(packs, mode):
    """Including the row lookahead of "row" on the grid's last step (the
    last row has several steps)."""
    rows, tgt_t, src = _inputs(packs, seed=10 + packs)
    kernel, scratch = tune2.make_kernel(packs, mode, G)
    want = _script_grid(kernel, rows, tgt_t, src, out_rows=True,
                        scratch=scratch or ())
    got = near_flat.flat_tune2(*_torch(rows, tgt_t, src), step_packs=packs,
                               mode=mode)
    _assert_rows_close(got.numpy(), np.asarray(want))


def test_the_two_out_modes_agree_bit_for_bit():
    """K10's "steps" adds a row's step partials in step order, which is
    what "rmw" carries: the same bits in the plain versions (and in the
    kernels, tests/test_torch_gpu.py)."""
    rows, tgt_t, src = _torch(*_inputs(8, seed=3))
    a, b = (near_flat.flat_tune(rows, tgt_t, src, step_packs=8, out_mode=m)
            for m in near_flat.OUT_MODES)
    assert torch.equal(a, b)


def test_flat_form_of_k1s_lists_equals_k1():
    """K1's lists cut into the flat form (pack_lists, every step size)
    through K9's and K11's plain versions give K1's plain near field."""
    L = probe.probe_lists(4096, "cpu", leaf=64)
    n_leaves, g, _ = L["tgt"].shape
    acc, pot = bh_kernels.near_field_plain(
        L["pos_s"], L["mass_s"], L["tgt"], L["idx"], L["valid"], g=1.0,
        softening=probe.SOFTENING, compute_pot=True)
    want = torch.cat([acc.reshape(n_leaves, g, 3),
                      -pot.reshape(n_leaves, g, 1)], dim=2).transpose(1, 2)
    eps2 = probe.SOFTENING ** 2
    src_leaves = L["table"].transpose(1, 2)
    for packs in near_flat.STEP_PACKS:
        rows, src, live, subs = near_flat.pack_lists(src_leaves, L["idx"],
                                                     L["valid"], packs)
        assert live == L["entries"] * g // near_flat.SUB <= subs
        per_row = torch.bincount(rows.long(), minlength=n_leaves)
        assert torch.equal(
            per_row, -(-L["valid"].sum(1) * (g // near_flat.SUB)
                       // (packs * near_flat.PACK_SUBS)))
        if packs == near_flat.PROTO_PACKS:
            got = near_flat.flat_near(rows, L["tgt_t"], src, eps2=eps2)
        else:
            got = near_flat.flat_tune2(rows, L["tgt_t"], src,
                                       step_packs=packs, mode="row",
                                       eps2=eps2)
        _assert_rows_close(got.numpy(), want.numpy())


def test_padding_is_zero_mass():
    L = probe.probe_lists(4096, "cpu", leaf=64)
    rows, src, live, subs = near_flat.pack_lists(
        L["table"].transpose(1, 2), L["idx"], L["valid"], 16)
    lane_mass = src[:, :, 3].reshape(-1, near_flat.SUB)
    assert int((lane_mass.abs().sum(1) == 0).sum()) == subs - live


@pytest.mark.parametrize("wrapper", ["flat_near", "flat_tune", "flat_tune2"])
def test_wrappers_refuse_rows_the_scripts_do_not_take(wrapper):
    rows, tgt_t, src = _torch(*_inputs(4))
    kw = {"flat_near": dict(eps2=1e-2),
          "flat_tune": dict(step_packs=4, out_mode="rmw"),
          "flat_tune2": dict(step_packs=4, mode="row")}[wrapper]
    fn = getattr(near_flat, wrapper)
    unsorted = rows.clone()
    unsorted[[1, 4]] = unsorted[[4, 1]]
    gap = rows.clone()
    gap[gap == 2] = 1                       # row 2 owns no step
    for bad in (unsorted, gap):
        with pytest.raises(ValueError, match="ascend"):
            fn(bad, tgt_t, src, **kw)
    with pytest.raises(ValueError, match="src"):
        fn(rows, tgt_t, src[:, :2], **kw)


def test_tools_need_the_card():
    for name, fn in flat_kernel.SUBCOMMANDS.items():
        with pytest.raises(RuntimeError, match="is_available"):
            fn() if name != "lists" else fn(n=16384)
    with pytest.raises(SystemExit):
        flat_kernel.main(["proto"])


@pytest.mark.parametrize("wrapper,kw", [
    ("flat_near", dict(eps2=1e-2)),
    ("flat_tune", dict(step_packs=4, out_mode="rmw")),
    ("flat_tune", dict(step_packs=4, out_mode="steps")),
    ("flat_tune2", dict(step_packs=4, mode="step")),
    ("flat_tune2", dict(step_packs=4, mode="row"))])
def test_sampled_rows_are_the_full_problems_rows(wrapper, kw):
    """flat_kernel.sample_rows (the tools' check of a bench launch): the
    plain version on the picked rows' own problem gives the full output's
    rows, bit for bit, the first and the last row among them."""
    rows, tgt_t, src = _torch(*_inputs(4, seed=5))
    fn = getattr(near_flat, wrapper)
    full = fn(rows, tgt_t, src, **kw)
    picked, sub = flat_kernel.sample_rows(rows, tgt_t, src, n_sample=3)
    assert len(picked) == 3
    assert (int(picked[0]), int(picked[-1])) == (0, len(STEPS_PER_ROW) - 1)
    assert torch.equal(fn(*sub, **kw), full[picked])


def test_held_rows_catches_a_wrong_row():
    args = _torch(*_inputs(4, seed=5))
    got = near_flat.flat_near(*args, eps2=1e-2)
    assert flat_kernel.held_rows("plain", got, args,
                                 near_flat.flat_near_plain, eps2=1e-2) == 0.0
    bad = got.clone()
    bad[-1, 0, 3] += 1e-2 * float(bad[-1].abs().max())
    with pytest.raises(AssertionError, match="row scale"):
        flat_kernel.held_rows("wrong", bad, args, near_flat.flat_near_plain,
                              eps2=1e-2)
