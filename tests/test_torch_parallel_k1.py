"""K1's two windowed entry forms (ops/bh_kernels.near_field with leaf_lo=
and src_table=, csrc/near_field.cu) on the CPU, through their plain
versions, against the JAX package's near_field_pallas(..., leaf_lo=) and
(..., src_t4=) in interpret mode on the same inputs; and the work items of
the windows (near_windows / near_items with per-row starts).

Inputs: the JAX package's Plummer ICs, sorted, its lists (tests/test_bh.py's
setup at N = 2048, leaf 32). Tolerance rtol 2e-4 / atol 2e-5 in f32 (the
bound of tests/test_bh.py for the Pallas kernels against their jnp
versions); the port's own forms against each other in f64 to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops.bh import _prepare, leaf_interactions, traverse
from parallelnbody_tpu.ops.pallas_bh import near_field_pallas
from parallelnbody_tpu_torch.ops import bh_kernels

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
LEAF = 32


@pytest.fixture(scope="module")
def lists():
    """JAX-sorted Plummer particles at N = 2048, leaf 32, and the JAX
    package's near lists (front-packed ascending)."""
    cfg = SimConfig(n=2048, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(23), cfg)
    pos_s, mass_s, _, tree, _, n_pad = _prepare(pos, mass, leaf_size=LEAF,
                                                curve="hilbert")
    n_leaves = n_pad // LEAF
    _, rej = traverse(tree, 0.5)
    idx, valid, _, _, _ = leaf_interactions(
        tree, rej, 0.5, start_leaf=0, n_slice=n_leaves, near_budget=64,
        far0_budget=256)
    return dict(pos_s=pos_s, mass_s=mass_s, idx=idx, valid=valid,
                tgt=pos_s.reshape(n_leaves, LEAF, 3), n_leaves=n_leaves)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _sparse(L):
    """The lists' mask with every third row emptied."""
    valid = _t(L["valid"]).clone()
    valid[::3] = False
    return valid


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n_sh", [2, 4])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_window_form_matches_near_field_pallas_leaf_lo(lists, n_sh,
                                                       compute_pot):
    """Each shard's window of leaf ids against the shard's particles, as
    the ring near field evaluates it: the port's window form equals
    near_field_pallas(..., leaf_lo=) (interpret mode) on every shard."""
    L = lists
    nl = L["n_leaves"] // n_sh
    for s in range(n_sh):
        rows = slice(s * nl * LEAF, (s + 1) * nl * LEAF)
        want = near_field_pallas(
            L["pos_s"][rows], L["mass_s"][rows], L["tgt"], L["idx"],
            L["valid"], LEAF, 1.0, 0.02, False, interpret=True,
            compute_pot=compute_pot, leaf_lo=jnp.int32(s * nl))
        got = bh_kernels.near_field(
            _t(L["pos_s"][rows]), _t(L["mass_s"][rows]), _t(L["tgt"]),
            _t(L["idx"]), _t(L["valid"]), g=1.0, softening=0.02,
            compute_pot=compute_pot, leaf_lo=s * nl)
        _close(got, want)


def test_window_forms_sum_to_full(lists):
    """The windows of 4 shards summed (f64) equal the unwindowed form."""
    L = lists
    args = dict(g=1.0, softening=0.02)
    pos = _t(L["pos_s"], torch.float64)
    mass = _t(L["mass_s"], torch.float64)
    tgt = _t(L["tgt"], torch.float64)
    idx, valid = _t(L["idx"]), _t(L["valid"])
    full = bh_kernels.near_field(pos, mass, tgt, idx, valid, **args)
    nl = L["n_leaves"] // 4
    acc = torch.zeros_like(full[0])
    pot = torch.zeros_like(full[1])
    for s in range(4):
        rows = slice(s * nl * LEAF, (s + 1) * nl * LEAF)
        a, p = bh_kernels.near_field(pos[rows], mass[rows], tgt, idx, valid,
                                     leaf_lo=s * nl, **args)
        acc, pot = acc + a, pot + p
    torch.testing.assert_close(acc, full[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(pot, full[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_rows", [17, 40])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_table_form_matches_near_field_pallas_src_t4(lists, n_rows,
                                                     compute_pot):
    """A prebuilt table of the first n_rows leaves: entries naming a leaf
    past it are skipped (the LET clip). The port's packed (n_rows * G, 4)
    table against near_field_pallas(..., src_t4=) with the JAX package's
    (n_rows, 4, G) lane layout of the same particles."""
    L = lists
    p4 = jnp.concatenate([L["pos_s"], L["mass_s"][:, None]], 1)
    p4 = p4[:n_rows * LEAF]
    t4 = jnp.swapaxes(p4.reshape(n_rows, LEAF, 4), 1, 2)
    want = near_field_pallas(None, None, L["tgt"], L["idx"], L["valid"],
                             LEAF, 1.0, 0.02, False, interpret=True,
                             compute_pot=compute_pot, src_t4=t4)
    got = bh_kernels.near_field(None, None, _t(L["tgt"]), _t(L["idx"]),
                                _t(L["valid"]), g=1.0, softening=0.02,
                                compute_pot=compute_pot, src_table=_t(p4))
    _close(got, want)
    # Some list ran past the table: the clip was exercised.
    assert bool(jnp.any(L["valid"] & (L["idx"] >= n_rows)))


def test_table_form_argument_check(lists):
    L = lists
    table = torch.zeros((LEAF, 4))
    with pytest.raises(ValueError, match="src_table"):
        bh_kernels.near_field(_t(L["pos_s"]), None, _t(L["tgt"]),
                              _t(L["idx"]), _t(L["valid"]), g=1.0,
                              softening=0.02, src_table=table)


def test_near_items_with_starts_cover_each_run(lists):
    """Items with per-row starts cover exactly each row's run [lo, hi) of
    list positions, once; with starts 0 they are the unwindowed items."""
    L = lists
    idx, valid = _t(L["idx"]), _t(L["valid"])
    counts = torch.sum(valid, 1)
    base = bh_kernels.near_items(counts, 7)
    zero = bh_kernels.near_items(counts, 7, lo=torch.zeros_like(counts))
    for a, b in zip(base[:2], zero[:2]):
        assert torch.equal(a, b)
    nl = L["n_leaves"] // 4
    edges = [w * nl for w in range(5)]
    works = bh_kernels.near_windows(idx, valid, edges, chunk=7)
    covered = torch.zeros(valid.shape, dtype=torch.int64)
    for w, (items, _, _) in enumerate(works):
        inside = valid & (idx >= edges[w]) & (idx < edges[w + 1])
        here = torch.zeros(valid.shape, dtype=torch.int64)
        for r, b, e, _ in items.tolist():
            assert 0 <= e - b <= 7
            here[r, b:e] += 1
        assert torch.equal(here, inside.long()), w
        covered += here
    assert torch.equal(covered, valid.long())


@pytest.mark.parametrize("n_sh,rank", [(2, 1), (4, 0), (4, 2)])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_accumulating_window_form_in_pass_order(lists, n_sh, rank,
                                                compute_pot):
    """The ring near field's accumulating window form (out=): the windows
    in rank `rank`'s pass order, the first written and the others added in
    place, equal the per-window results added in the same order bit for
    bit, and the same sum of near_field_pallas(..., leaf_lo=) (interpret
    mode) within the f32 tolerance."""
    L = lists
    nl = L["n_leaves"] // n_sh
    tgt, idx, valid = _t(L["tgt"]), _t(L["idx"]), _t(L["valid"])
    kw = dict(g=1.0, softening=0.02, compute_pot=compute_pot)
    out = added = want = None
    for p in range(n_sh):
        s = (rank - p) % n_sh
        rows = slice(s * nl * LEAF, (s + 1) * nl * LEAF)
        pos, mass = _t(L["pos_s"][rows]), _t(L["mass_s"][rows])
        out = bh_kernels.near_field(pos, mass, tgt, idx, valid, leaf_lo=s * nl,
                                    out=out, **kw)
        a = bh_kernels.near_field(pos, mass, tgt, idx, valid, leaf_lo=s * nl,
                                  **kw)
        added = a if added is None else tuple(x + y for x, y in zip(added, a))
        w = near_field_pallas(
            L["pos_s"][rows], L["mass_s"][rows], L["tgt"], L["idx"],
            L["valid"], LEAF, 1.0, 0.02, False, interpret=True,
            compute_pot=compute_pot, leaf_lo=jnp.int32(s * nl))
        want = w if want is None else tuple(x + y for x, y in zip(want, w))
    for got, ref in zip(out, added):
        assert torch.equal(got, ref)
    _close(out, want)


@pytest.mark.parametrize("compute_pot", [True, False])
def test_accumulating_window_form_leaves_empty_rows_untouched(lists,
                                                               compute_pot):
    """Adding a window into an output leaves the rows with no entry in it
    as they were (bit for bit, -0.0 included), and the potential as it was
    without the potential. Every third row's list is emptied (at this N
    each list names every leaf)."""
    L = lists
    nl = L["n_leaves"] // 4
    tgt, idx, valid = _t(L["tgt"]), _t(L["idx"]), _sparse(L)
    s = 3
    rows = slice(s * nl * LEAF, (s + 1) * nl * LEAF)
    n = tgt.shape[0] * LEAF
    out = (torch.full((n, 3), -0.0), torch.full((n,), -0.0))
    bh_kernels.near_field(_t(L["pos_s"][rows]), _t(L["mass_s"][rows]), tgt,
                          idx, valid, g=1.0, softening=0.02,
                          compute_pot=compute_pot, leaf_lo=s * nl, out=out)
    inside = (valid & (idx >= s * nl) & (idx < (s + 1) * nl)).any(1)
    empty = ~inside.repeat_interleave(LEAF)
    assert bool(empty.any()) and bool(inside.any())
    assert bool(torch.signbit(out[0][empty]).all())
    assert bool((out[0][~empty] != 0).any())
    if not compute_pot:
        assert bool(torch.signbit(out[1]).all())


def test_window_shape_follows_the_window_work():
    """window_shape: a window whose pair terms fill the card many times
    over keeps one-warp blocks (8 targets a thread at leaf 256); lighter
    windows take shorter items, then fewer targets a thread; R never
    exceeds the leaf size's full-warp R. The windows of rank 0 of the 4M
    LET example (entries, longest row) pick the shapes measured fastest on
    the card (bh_kernels.WINDOW_TAIL)."""
    shape = bh_kernels.window_shape
    assert shape(130093, 160, 256, 132) == (8, 8)
    assert shape(10 ** 7, 191, 256, 132) == (8, 32)
    assert shape(9272, 51, 256, 132) == (1, 4)
    assert shape(112, 24, 256, 132) == (1, 1)
    assert shape(0, 0, 256, 132) == (8, 32)      # nothing to sweep
    assert shape(137000, 191, 128, 132)[0] == 4
    assert shape(137000, 191, 64, 132)[0] == 2
    last = None
    for entries in (10, 100, 1000, 10000, 100000, 1000000):
        r, chunk = shape(entries, 64, 256, 132)
        order = bh_kernels.WINDOW_SHAPES.index((r, chunk))
        assert last is None or order <= last
        last = order


@pytest.mark.parametrize("writes", [None, (1,), ()])
def test_shaped_windows_cover_each_run(lists, writes):
    """Windows shaped by their own work (near_windows without a chunk):
    each window's items cover its run of each row once, in items of at
    most its chunk; the windows in `writes` give every row an item (an
    empty row one empty item), the others none to a row without entries."""
    L = lists
    idx, valid = _t(L["idx"]), _sparse(L)
    nl = L["n_leaves"] // 4
    edges = [w * nl for w in range(5)]
    works = bh_kernels.near_windows(idx, valid, edges, writes=writes,
                                    leaf_size=LEAF, n_sm=132)
    for w, work in enumerate(works):
        inside = valid & (idx >= edges[w]) & (idx < edges[w + 1])
        counts = inside.sum(1)
        assert (work.r, work.chunk) == bh_kernels.window_shape(
            int(counts.sum()), int(counts.max()), LEAF, 132)
        every_row = writes is None or w in writes
        assert work.every_row == every_row
        here = torch.zeros(valid.shape, dtype=torch.int64)
        rows_seen = torch.zeros(valid.shape[0], dtype=torch.bool)
        for r, b, e, _ in work.items.tolist():
            assert 0 <= e - b <= work.chunk
            here[r, b:e] += 1
            rows_seen[r] = True
        assert torch.equal(here, inside.long()), w
        assert torch.equal(rows_seen, torch.ones_like(rows_seen) if every_row
                           else counts > 0)
