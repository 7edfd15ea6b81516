"""Traversal and dense-octet interaction lists: the port against the JAX
package. The list tests start from the JAX tree converted to torch, so that
no MAC decision can flip on f32 rounding of the pyramid: masks, lists, the
node table and the overflow count must then be equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu_torch.config import SimConfig as TorchConfig
from parallelnbody_tpu_torch.ops import bh as tbh

torch.set_num_threads(2)


def _plummer_np(n, seed):
    cfg = JaxConfig(n=n, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(seed), cfg)
    return np.array(pos), np.array(mass)


def _to_torch_tree(jt):
    conv = lambda level: (None if level is None  # noqa: E731
                          else torch.from_numpy(np.array(level)))
    return tbh.BHTree(*(tuple(conv(x) for x in getattr(jt, f))
                        for f in ("com", "mass", "radius", "quad")))


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.fixture(scope="module", params=[(4096, 11), (3000, 4)],
            ids=["n4096", "n3000-padded"])
def trees(request):
    n, seed = request.param
    pos, mass = _plummer_np(n, seed)
    jt = jbh._prepare(jnp.asarray(pos), jnp.asarray(mass), leaf_size=32,
                      curve="hilbert", multipole_order=2)[3]
    return jt, _to_torch_tree(jt)


@pytest.mark.parametrize("theta", [0.55, 0.72])
def test_traverse_masks_equal(trees, theta):
    jt, tt = trees
    jf, jr = jbh.traverse(jt, theta)
    tf, tr = tbh.traverse(tt, theta)
    _eq(tr, jr, "rejects")
    for k in range(1, jt.n_levels):
        _eq(tf[k], jf[k], f"far_masks[{k}]")


@pytest.mark.parametrize("budgets", [(4096, 4096), (128, 256), (2, 8)],
                         ids=["wide", "calibrated", "overflow"])
def test_octet_lists_equal(trees, budgets):
    jt, tt = trees
    near_b, far_b = budgets
    n_leaves = jt.com[0].shape[0]
    kw = dict(theta=0.72, start_leaf=0, n_slice=n_leaves,
              near_budget=near_b, far_budget=far_b)
    jf, jr = jbh.traverse(jt, 0.72)
    tf, tr = tbh.traverse(tt, 0.72)
    jout = jbh.build_interaction_lists_octet(jt, jf, jr, dtype=jnp.float32,
                                             **kw)
    tout = tbh.build_interaction_lists_octet(tt, tf, tr, dtype=torch.float32,
                                             **kw)
    names = ("near_idx", "near_valid", "far_keys", "far_valid", "nodes8",
             "overflow")
    for name, t, j in zip(names, tout, jout):
        _eq(t, j, name)
    assert tout[0].dtype == tout[2].dtype == torch.int32
    if budgets == (2, 8):
        assert int(tout[5]) > 0
    else:
        assert int(tout[5]) == 0


def test_measure_budget_requirements_equal():
    pos, mass = _plummer_np(4096, 7)
    kw = dict(n=4096, theta=0.72, bh_leaf_size=32, force="barnes_hut")
    jr = jbh.measure_budget_requirements(jnp.asarray(pos), jnp.asarray(mass),
                                         JaxConfig(**kw))
    tr = tbh.measure_budget_requirements(torch.from_numpy(pos),
                                         torch.from_numpy(mass),
                                         TorchConfig(**kw))
    assert tr == jr
    assert tr["refine"] == "dense" and tr["far_mode"] == "octet"


def _octet_cover_counts(tree, far_keys, far_valid):
    """Per-target count of source leaves covered by an octet far list: each
    set mask bit of a level-k octet entry covers n_leaves/n_k leaves."""
    widths = [c.shape[0] for c in tree.com]
    offs8, _ = tbh._octet_offsets(widths)
    n_leaves = widths[0]
    keys = np.where(far_valid.numpy(), far_keys.numpy(), -1)
    octs, bits = keys >> 8, keys & 0xFF
    nset = sum((bits >> b) & 1 for b in range(8))
    cover = np.zeros(keys.shape[0], np.int64)
    for k in range(tree.n_levels):
        lo, hi = offs8[k], offs8[k] + (-(-widths[k] // 8))
        in_level = (octs >= lo) & (octs < hi) & (keys >= 0)
        cover += (nset * in_level).sum(1) * (n_leaves // widths[k])
    return cover


@pytest.mark.parametrize("n", [4096, 3000])
def test_lists_cover_every_pair_exactly_once(n):
    """From raw positions, with the port's own tree: every (target leaf,
    source leaf) pair of a real target is covered by exactly one near entry
    or one accepted far node, weighted by its leaf count."""
    pos, mass = _plummer_np(n, 11)
    _, _, _, tree, _, n_pad = tbh._prepare(
        torch.from_numpy(pos), torch.from_numpy(mass), leaf_size=32,
        curve="hilbert", multipole_order=2)
    n_leaves = n_pad // 32
    far, rej = tbh.traverse(tree, 0.55)
    ni, nv, fk, fv, nodes8, of = tbh.build_interaction_lists_octet(
        tree, far, rej, theta=0.55, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0
    assert nodes8.shape[0] % 8 == 0
    cover = _octet_cover_counts(tree, fk, fv) + nv.sum(1).numpy()
    real = tree.mass[0].numpy() > 0
    np.testing.assert_array_equal(cover[real], n_leaves)
    assert not cover[~real].any()
    # near lists ascending and front-packed (the kernels rely on both)
    for r in range(n_leaves):
        row = ni[r][nv[r]].numpy()
        assert np.all(np.diff(row) > 0)
        assert not nv[r][int(nv[r].sum()):].any()
