"""Staged refinement and sections: the port against the JAX package.

List tests start from the JAX tree converted to torch, so that no MAC
decision can flip on the rounding of the pyramid (ROADMAP Queue 3): the
staged lists (octet and gather form), the node tables and the overflow
counts must then be equal bit for bit. From raw positions, with the port's
own tree, the lists must cover every (target leaf, source leaf) pair exactly
once. Force comparisons run in f64, where the port and the JAX package sum
the same terms in another order: rtol 1e-9 / atol 1e-12 (the bound of
tests/test_bh.py:579 for staged against dense). Sectioned results are held
bitwise against unsectioned ones in tests/test_torch_sections.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.ops.morton import morton_encode as j_morton
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.ops import bh_kernels

torch.set_num_threads(2)

F64 = dict(rtol=1e-9, atol=1e-12)


def _plummer_np(n, seed, dtype="float64"):
    cfg = JaxConfig(n=n, ic="plummer", dtype=dtype)
    pos, _, mass = get_ic("plummer")(jax.random.key(seed), cfg)
    return np.array(pos), np.array(mass)


def _to_torch_tree(jt):
    conv = lambda level: (None if level is None  # noqa: E731
                          else torch.from_numpy(np.array(level)))
    return tbh.BHTree(*(tuple(conv(x) for x in getattr(jt, f))
                        for f in ("com", "mass", "radius", "quad")))


def _morton_tree(n, seed, dtype, leaf=32, multipole=1):
    """The tree of tests/test_bh.py:534: Morton-sorted Plummer particles,
    leaf 32, sentinel (10, 10, 10); the JAX tree and its torch copy."""
    pos, mass = _plummer_np(n, seed, dtype)
    pos, mass = jnp.asarray(pos), jnp.asarray(mass)
    keys = j_morton(pos, jnp.zeros(3), jnp.max(jnp.abs(pos)) + 1e-3)
    perm = jnp.argsort(keys)
    jt = jbh.build_tree(pos[perm], mass[perm], leaf,
                        jnp.asarray([10.0, 10.0, 10.0], pos.dtype),
                        multipole_order=multipole)
    return jt, _to_torch_tree(jt)


@pytest.fixture(scope="module", params=[(16384, 1, "float64", 1),
                                        (4096, 11, "float32", 2)],
                ids=["n16384-f64", "n4096-f32-quad"])
def trees(request):
    n, seed, dtype, multipole = request.param
    jt, tt = _morton_tree(n, seed, dtype, multipole=multipole)
    return jt, tt, dtype


def _staged_both(jt, tt, dtype, *, theta, **kw):
    jf, jr = jbh.traverse(jt, theta, stop_level=2)
    tf, tr = tbh.traverse(tt, theta, stop_level=2)
    n_leaves = jt.com[0].shape[0]
    common = dict(theta=theta, start_leaf=0, n_slice=n_leaves, **kw)
    jout = jbh.build_interaction_lists_staged(
        jt, jf, jr, dtype=getattr(jnp, dtype), **common)
    tout = tbh.build_interaction_lists_staged(
        tt, tf, tr, dtype=getattr(torch, dtype), **common)
    return jout, tout


NAMES = ("near_idx", "near_valid", "far_idx", "far_valid", "nodes",
         "overflow")


@pytest.mark.parametrize("octet_far", [True, False], ids=["octet", "gather"])
@pytest.mark.parametrize("budgets", ["full", "clipping"])
def test_staged_lists_equal_jax(trees, octet_far, budgets):
    """Every output of build_interaction_lists_staged, on the JAX tree, at
    budgets wide enough for every entry and at budgets that clip each
    stage (equal overflow counts, > 0)."""
    jt, tt, dtype = trees
    widths = [c.shape[0] for c in jt.com]
    n_leaves = widths[0]
    if budgets == "full":
        kw = dict(near_budget=n_leaves, far_budget=2 * n_leaves,
                  cand2_budget=widths[2], cand1_budget=widths[1])
    else:
        kw = dict(near_budget=24, far_budget=40, cand2_budget=6,
                  cand1_budget=20)
    jout, tout = _staged_both(jt, tt, dtype, theta=0.5, octet_far=octet_far,
                              **kw)
    for name, t, j in zip(NAMES, tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert tout[0].dtype == tout[2].dtype == torch.int32
    if budgets == "full":
        assert int(tout[5]) == 0
    else:
        assert int(tout[5]) > 0


@pytest.mark.parametrize("octet_far", [True, False], ids=["octet", "gather"])
def test_staged_row_blocking_matches(octet_far):
    """Row blocking (tests/test_bh.py:619) changes no bit of the lists or
    the overflow count; both equal the JAX package's."""
    jt, tt = _morton_tree(4096, 13, "float64")
    jout, tout = _staged_both(jt, tt, "float64", theta=0.5,
                              octet_far=octet_far, near_budget=128,
                              far_budget=256, cand2_budget=16,
                              cand1_budget=64)
    tf, tr = tbh.traverse(tt, 0.5, stop_level=2)
    blk = tbh.build_interaction_lists_staged(
        tt, tf, tr, theta=0.5, start_leaf=0, n_slice=tt.com[0].shape[0],
        near_budget=128, far_budget=256, cand2_budget=16, cand1_budget=64,
        dtype=torch.float64, octet_far=octet_far, row_block=16)
    for name, a, b, j in zip(NAMES, tout, blk, jout):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("n_rows,row_block,block", [
    (64, 16, 16), (64, 0, 64), (48, 20, 12), (6, 4, 3), (7, 4, 1)])
def test_map_row_blocks_block_choice(n_rows, row_block, block):
    """n_rows halved while above row_block or not dividing n_rows (one shot
    without blocking, single rows for an odd n_rows); the outputs join
    along rows, scalars stack."""
    seen = []

    def fn(args):
        (x,) = args
        seen.append(x.shape[0])
        return x * 2, torch.sum(x)

    x = torch.arange(n_rows)
    y, s = tbh._map_row_blocks(fn, (x,), n_rows,
                               row_block if row_block else n_rows)
    assert set(seen) == {block}
    assert torch.equal(y, 2 * x)
    assert int(torch.sum(s)) == int(x.sum())


def _level_weights(widths):
    w = np.zeros(sum(widths), np.int64)
    off = 0
    for wk in widths:
        w[off:off + wk] = widths[0] // wk
        off += wk
    return w


def _octet_cover(widths, keys, valid):
    offs8, _ = tbh._octet_offsets(widths)
    keys = np.where(valid, keys, -1)
    octs, bits = keys >> 8, keys & 0xFF
    nset = sum((bits >> b) & 1 for b in range(8))
    cover = np.zeros(keys.shape[0], np.int64)
    for k in range(len(widths)):
        lo, hi = offs8[k], offs8[k] + (-(-widths[k] // 8))
        in_level = (octs >= lo) & (octs < hi) & (keys >= 0)
        cover += (nset * in_level).sum(1) * (widths[0] // widths[k])
    return cover


@pytest.mark.parametrize("octet_far", [True, False], ids=["octet", "gather"])
def test_staged_lists_cover_every_pair_exactly_once(octet_far):
    """From raw positions, with the port's own tree (tests/test_bh.py:534):
    every (target leaf, source leaf) pair covered by exactly one near
    entry or one accepted node, weighted by its leaf count; near lists
    ascending, no source twice."""
    pos, mass = _plummer_np(16384, 1)
    _, _, _, tree, _, n_pad = tbh._prepare(
        torch.from_numpy(pos), torch.from_numpy(mass), leaf_size=32,
        curve="hilbert")
    n_leaves = n_pad // 32
    widths = [c.shape[0] for c in tree.com]
    assert len(widths) == 4  # a real 2-stage refine (l2 is not the root)
    far, rej2 = tbh.traverse(tree, 0.5, stop_level=2)
    ni, nv, fi, fv, nodes, of = tbh.build_interaction_lists_staged(
        tree, far, rej2, theta=0.5, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=2 * n_leaves,
        cand2_budget=widths[2], cand1_budget=widths[1], dtype=torch.float64,
        octet_far=octet_far)
    assert int(of) == 0
    ni, nv, fi, fv = (t.numpy() for t in (ni, nv, fi, fv))
    if octet_far:
        assert nodes.shape[0] % 8 == 0
        far_cover = _octet_cover(widths, fi, fv)
    else:
        assert nodes.shape[0] == sum(widths)
        far_cover = (_level_weights(widths)[fi] * fv).sum(1)
    np.testing.assert_array_equal(nv.sum(1) + far_cover, n_leaves)
    for r in range(n_leaves):
        assert np.all(np.diff(ni[r][nv[r]]) > 0)
        assert not nv[r][int(nv[r].sum()):].any()
        if not octet_far:
            both = np.concatenate([ni[r][nv[r]], fi[r][fv[r]] + sum(widths)])
            assert len(set(both.tolist())) == len(both)


def test_padding_target_leaves_get_empty_staged_lists():
    """Zero-mass (padding) target leaves consume no list budget
    (tests/test_bh.py:662): their staged lists are empty in both forms."""
    pos, mass = _plummer_np(2100, 5)
    _, _, _, tree, _, n_pad = tbh._prepare(
        torch.from_numpy(pos), torch.from_numpy(mass), leaf_size=32,
        curve="hilbert")
    phantom = tree.mass[0] == 0
    assert bool(phantom.any())
    far, rej2 = tbh.traverse(tree, 0.5, stop_level=2)
    for octet_far in (True, False):
        _, nv, _, fv, _, _ = tbh.build_interaction_lists_staged(
            tree, far, rej2, theta=0.5, start_leaf=0, n_slice=n_pad // 32,
            near_budget=64, far_budget=512, cand2_budget=32,
            cand1_budget=64, dtype=torch.float64, octet_far=octet_far)
        assert not bool(nv[phantom].any()) and not bool(fv[phantom].any())


def _accel_kw(**kw):
    return dict(leaf_size=32, theta=0.6, g=1.0, softening=0.02,
                near_budget=512, far0_budget=1024, multipole=2) | kw


@pytest.mark.parametrize("far_mode", ["octet", "gather"])
def test_staged_matches_dense_forces(far_mode):
    """Staged and dense refinement make identical MAC decisions, so the
    forces agree to f64 summation order (tests/test_bh.py:579); starved
    candidate budgets report overflow."""
    pos, mass = (torch.from_numpy(a) for a in _plummer_np(8192, 11))
    kw = _accel_kw(far_mode=far_mode)
    if far_mode == "gather":   # the staged gather list holds every class
        kw["far0_budget"] = 4096
    a_d, p_d, of_d = tbh.bh_accel(pos, mass, refine="dense", **kw)
    a_s, p_s, of_s = tbh.bh_accel(pos, mass, refine="staged", **kw)
    assert int(of_d) == 0 and int(of_s) == 0
    np.testing.assert_allclose(a_s.numpy(), a_d.numpy(), **F64)
    np.testing.assert_allclose(p_s.numpy(), p_d.numpy(), **F64)
    _, _, of_t = tbh.bh_accel(pos, mass, refine="staged",
                              cand_budgets=(2, 4), **kw)
    assert int(of_t) > 0


@pytest.mark.parametrize("far_mode", ["octet", "gather"])
@pytest.mark.parametrize("sections", [1, 4])
def test_staged_bh_accel_matches_jax(far_mode, sections):
    """Staged bh_accel from raw positions, f64, against the JAX package's
    (jnp kernels), unsectioned and in 4 windows."""
    pos, mass = _plummer_np(8192, 3)
    kw = _accel_kw(refine="staged", far_mode=far_mode, sections=sections,
                   far0_budget=1024 if far_mode == "octet" else 4096)
    ja, jp, jof = jbh.bh_accel(jnp.asarray(pos), jnp.asarray(mass), **kw)
    ta, tp, tof = tbh.bh_accel(torch.from_numpy(pos),
                               torch.from_numpy(mass), **kw)
    assert int(tof) == int(jof) == 0
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F64)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **F64)


@pytest.mark.parametrize("refine", ["dense", "staged"])
def test_octet_far_matches_gather(refine):
    """far_mode="octet" evaluates the same interaction set as "gather"
    (tests/test_bh.py:752): f32 forces within 1e-5 relative norm."""
    pos, mass = (torch.from_numpy(a) for a in _plummer_np(4096, 4, "float32"))
    kw = dict(leaf_size=32, theta=0.6, g=1.0, softening=0.02,
              near_budget=128, far0_budget=512, multipole=2, refine=refine)
    ag, pg, og = tbh.bh_accel(pos, mass, far_mode="gather", **kw)
    ao, po, oo = tbh.bh_accel(pos, mass, far_mode="octet", **kw)
    assert int(og) == 0 and int(oo) == 0
    assert float(torch.linalg.norm(ag - ao) / torch.linalg.norm(ag)) < 1e-5
    assert float(torch.linalg.norm(pg - po) / torch.linalg.norm(pg)) < 1e-5


def test_duplicate_octet_entries_are_each_summed():
    """Staged octet lists may name one octet twice with disjoint child
    masks (two parents of branch factor < 8): far_octet_plain sums both
    entries, as one entry of the union mask would."""
    gen = torch.Generator().manual_seed(2)
    nodes8 = torch.randn((64, 9), generator=gen, dtype=torch.float64)
    nodes8[:, 3] = nodes8[:, 3].abs()
    nodes8[:, :3] += 6.0
    tgt = 0.1 * torch.randn((2, 16, 3), generator=gen, dtype=torch.float64)
    oct_ = 5
    split = torch.tensor([[(oct_ << 8) | 0x0F, (oct_ << 8) | 0xF0, 0],
                          [(oct_ << 8) | 0x33, (oct_ << 8) | 0xCC, 0]],
                         dtype=torch.int32)
    union = torch.tensor([[(oct_ << 8) | 0xFF, 0, 0]] * 2, dtype=torch.int32)
    kw = dict(g=1.3, softening=0.02, compute_pot=True)
    a2, p2 = bh_kernels.far_octet_plain(
        tgt, nodes8, split, torch.tensor([[True, True, False]] * 2), **kw)
    a1, p1 = bh_kernels.far_octet_plain(
        tgt, nodes8, union, torch.tensor([[True, False, False]] * 2), **kw)
    np.testing.assert_allclose(a2.numpy(), a1.numpy(), rtol=1e-13)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=1e-13)


def test_staged_lists_on_a_three_level_tree():
    """32 leaves: levels 32 -> 4 -> 1, so level 2 is the root, its branch
    factor 4 and level 1 half an octet. The staged lists still equal the
    JAX package's and cover every pair exactly once."""
    jt, tt = _morton_tree(1024, 6, "float64")
    widths = [c.shape[0] for c in jt.com]
    assert widths == [32, 4, 1]
    for octet_far in (True, False):
        jout, tout = _staged_both(jt, tt, "float64", theta=0.5,
                                  octet_far=octet_far, near_budget=32,
                                  far_budget=64, cand2_budget=1,
                                  cand1_budget=4)
        for name, t, j in zip(NAMES, tout, jout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
        assert int(tout[5]) == 0
        if octet_far:
            cover = _octet_cover(widths, tout[2].numpy(), tout[3].numpy())
            np.testing.assert_array_equal(cover + tout[1].sum(1).numpy(), 32)
