"""ops/bh.py tree_stats and leaf_aabbs in the port against the JAX package's,
on the same numpy positions: every integer (widths, counts, overflow,
budgets) exactly, every float (radii percentiles, list-length means and
percentiles, box corners) to rtol 1e-6, in all three branches of
tree_stats (dense octet, dense gather, staged octet) and at clipping
budgets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.ops import bh as tbh

torch.set_num_threads(2)


def _plummer(n, seed=0):
    rng = np.random.default_rng(seed)
    r = 1.0 / np.sqrt(rng.uniform(0.01, 1.0, n) ** (-2.0 / 3.0) - 1.0)
    d = rng.standard_normal((n, 3))
    pos = (d / np.linalg.norm(d, axis=1, keepdims=True) * r[:, None])
    mass = np.full(n, 1.0 / n)
    return pos.astype(np.float32), mass.astype(np.float32)


def _assert_same(t, j, path="out"):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _assert_same(t[k], j[k], f"{path}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(j, float) and not float(j).is_integer():
        assert t == pytest.approx(j, rel=1e-6), path
    else:
        assert t == j, path


CASES = {
    "dense-octet": dict(n=4096, bh_leaf_size=32, theta=0.5),
    "dense-gather": dict(n=4096, bh_leaf_size=32, theta=0.5,
                         bh_far_mode="gather"),
    "staged-octet": dict(n=8192, bh_leaf_size=16, theta=0.6,
                         bh_refine="staged"),
    "staged-clipping": dict(n=8192, bh_leaf_size=16, theta=0.6,
                            bh_refine="staged", bh_near_budget=16,
                            bh_far_budget=64, bh_cand_budget=16,
                            bh_cand2_budget=8),
}


@pytest.mark.parametrize("name", CASES)
def test_tree_stats_equal_jax(name):
    kw = CASES[name]
    pos, mass = _plummer(kw["n"])
    t = tbh.tree_stats(torch.from_numpy(pos), torch.from_numpy(mass),
                       SimConfig(**kw))
    j = jbh.tree_stats(jnp.asarray(pos), jnp.asarray(mass), JaxConfig(**kw))
    _assert_same(t, j)
    if name == "staged-clipping":
        assert t["overflow"] > 0
    else:
        assert t["overflow"] == 0


@pytest.mark.parametrize("leaf_size,curve", [(16, "hilbert"), (64, "morton"),
                                             (32, "hilbert")])
def test_leaf_aabbs_equal_jax(leaf_size, curve):
    """Box corners and occupancy, with padding leaves (N not a multiple of
    the leaf size) left unoccupied."""
    pos, mass = _plummer(3000, seed=leaf_size)
    lo, hi, occ = tbh.leaf_aabbs(torch.from_numpy(pos),
                                 torch.from_numpy(mass), leaf_size=leaf_size,
                                 curve=curve)
    jlo, jhi, jocc = jbh.leaf_aabbs(jnp.asarray(pos), jnp.asarray(mass),
                                    leaf_size=leaf_size, curve=curve)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert not bool(occ.all())
    o = occ.numpy()
    np.testing.assert_allclose(lo.numpy()[o], np.asarray(jlo)[o], rtol=1e-6)
    np.testing.assert_allclose(hi.numpy()[o], np.asarray(jhi)[o], rtol=1e-6)
