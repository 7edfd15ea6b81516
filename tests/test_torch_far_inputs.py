"""What the wrappers of K2 and K4 prepare in Python, on the CPU: the node
rows the kernels stage (ops/bh_kernels.far_rows) and the order in which
they run their target leaves (ops/bh_kernels.heaviest_first).

The kernels copy node rows into shared memory with 16-byte cp.async copies,
so a multipole table (n, 9) [x, y, z, m, Qxx, Qyy, Qxy, Qxz, Qyz] is packed
into (n, 12) [x, y, z, m, Qxx, Qyy, Qxy, Qxz, Qyz, Qzz, 0, 0] with
Qzz = -(Qxx + Qyy) (csrc/terms.cuh quad_term). Here: the packing of the JAX
package's own node tables (the octet table of K2, the upper and leaf tables
of K4) equals the table plus Qzz bit for bit, rows start on 16-byte
boundaries, and a monopole table (n, 4) passes as it is, or aligned. The
launch order is a permutation of the leaves, longest list first, stable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu_torch.ops import bh_kernels

torch.set_num_threads(2)

LEAF = 16


@pytest.fixture(scope="module")
def tables():
    """The JAX package's quadrupole node tables at N = 2048, leaf 16,
    theta 0.72, as numpy arrays: {"octet": nodes8, "upper": nodes_up,
    "leaf": leaf_nodes}."""
    cfg = JaxConfig(n=2048, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(3), cfg)
    _, _, _, jt, _, n_pad = jbh._prepare(pos, mass, leaf_size=LEAF,
                                         curve="hilbert", multipole_order=2)
    n_leaves = n_pad // LEAF
    far, rej = jbh.traverse(jt, 0.72)
    kw = dict(theta=0.72, start_leaf=0, n_slice=n_leaves,
              near_budget=n_leaves, dtype=jnp.float32)
    octet = jbh.build_interaction_lists_octet(jt, far, rej,
                                              far_budget=n_leaves, **kw)
    gather = jbh.build_interaction_lists(jt, far, rej, far0_budget=n_leaves,
                                         **kw)
    return {"octet": np.array(octet[4]), "upper": np.array(gather[6]),
            "leaf": np.array(gather[7])}


@pytest.mark.parametrize("name", ["octet", "upper", "leaf"])
def test_far_rows_are_the_table_plus_qzz(tables, name):
    table = tables[name]
    assert table.shape[1] == 9 and table.dtype == np.float32
    rows = bh_kernels.far_rows(torch.from_numpy(table))
    assert rows.dtype == torch.float32 and tuple(rows.shape) == (
        table.shape[0], 12)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
    rows = rows.numpy()
    qzz = -(table[:, 4] + table[:, 5])
    np.testing.assert_array_equal(rows[:, :9], table)
    np.testing.assert_array_equal(rows[:, 9], qzz)
    np.testing.assert_array_equal(rows[:, 10:], 0.0)
    assert np.any(qzz != 0)


@pytest.mark.parametrize("name", ["octet", "upper", "leaf"])
def test_far_rows_of_a_monopole_table(tables, name):
    """(n, 4) rows are already 16 bytes: an aligned table is used as it is;
    one whose rows start off a 16-byte boundary is copied to one that is."""
    table = torch.from_numpy(np.ascontiguousarray(tables[name][:, :4]))
    assert table.data_ptr() % 16 == 0
    assert bh_kernels.far_rows(table) is table
    buf = torch.zeros(table.numel() + 1, dtype=torch.float32)
    shifted = buf[1:].view(-1, 4)
    shifted.copy_(table)
    assert shifted.data_ptr() % 16 != 0
    rows = bh_kernels.far_rows(shifted)
    assert rows.data_ptr() % 16 == 0
    assert torch.equal(rows, table)


@pytest.mark.parametrize("case", ["octet", "gather_leaf", "ties"])
def test_heaviest_first_is_a_stable_permutation(case):
    """Every leaf once, list lengths non-increasing along the order, leaves
    of equal length in ascending order (a stable sort), int32."""
    if case == "ties":
        counts = torch.tensor([3, 0, 3, 7, 0, 3, 7, 1], dtype=torch.int32)
    else:
        rng = np.random.default_rng(4 if case == "octet" else 5)
        budget = 96 if case == "octet" else 400
        counts = torch.from_numpy(
            rng.integers(0, budget, size=512).astype(np.int32))
    order = bh_kernels.heaviest_first(counts)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values,
                       torch.arange(counts.shape[0], dtype=torch.int32))
    c = counts[order.long()]
    assert bool((c[:-1] >= c[1:]).all())
    same = c[:-1] == c[1:]
    assert bool((order[:-1][same] < order[1:][same]).all())
    if case == "ties":
        assert order.tolist() == [3, 6, 0, 2, 5, 7, 1, 4]
