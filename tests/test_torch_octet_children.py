"""Staged octet keys of a parent with more than 8 children.

`build_upper` collapses a level whose width is no multiple of 8 into one
node of b = width children. A single device never builds such a tree
(`plan_tree` rounds the leaf count up to a power of two), a distributed
staged tree does: its leaf count is ranks x leaves a rank. The JAX
package's `_octet_keys_children` packs all b bits into one key, so for
b > 8 bits 8 and up carry into the octet id; the port emits one key per
octet the children cover. Held here:

  * b = 2, 4 and 8: the port's keys are the JAX package's, bit for bit;
  * b = 10 and 20: the port's keys decode to exactly the children of the
    mask (and the JAX package's do not);
  * on the staged trees of 4 ranks x 40 leaves (levels 160 / 20 / 1,
    N = 4096, leaf 32) and 8 ranks x 10 leaves (80 / 10 / 1, N = 2048),
    laid out as the ranks own them (contiguous curve ranges, each padded
    to its own capacity): the octet far list names exactly the nodes of
    the gather far list (`octet_far=False`, keyed by node id, right for
    any b), the octet forces equal the gather forces to 1e-5 relative,
    and both are in the rms class (< 2e-3) against the direct sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallelnbody_tpu.models as jmodels
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.ops.bh import INT32_MAX
from parallelnbody_tpu_torch.ops.direct import direct_accel
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode

torch.set_num_threads(2)

THETA = 0.72
LEAF = 32
RMS_CLASS = 2e-3
GATHER_OCTET = 1e-5


def _random_masks(b, seed, rows=16, cands=6):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, cands, b)) < 0.4
    mask[0, 0] = True                       # every child of one parent
    mask[0, 1] = False                      # and none of another
    return mask


@pytest.mark.parametrize("b", [2, 4, 8])
def test_keys_equal_jax_up_to_8_children(b):
    mask = _random_masks(b, b)
    rng = np.random.default_rng(100 + b)
    n_parents = 64
    parent = rng.integers(0, n_parents, mask.shape[:2]).astype(np.int32)
    want = jbh._octet_keys_children(jnp.asarray(mask), jnp.asarray(parent),
                                    5, b)
    got = tbh._octet_keys_children(torch.from_numpy(mask),
                                   torch.from_numpy(parent), 5, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decode(keys, oct_off):
    """Children named by octet keys, as (row, candidate, child) triples."""
    keys = keys.reshape(keys.shape[0], keys.shape[1], -1)
    out = set()
    for r, c, o in zip(*np.nonzero(keys != INT32_MAX)):
        key = int(keys[r, c, o])
        for bit in range(8):
            if key >> bit & 1:
                out.add((int(r), int(c), ((key >> 8) - oct_off) * 8 + bit))
    return out


@pytest.mark.parametrize("b", [10, 20])
def test_keys_decode_to_the_children_past_8(b):
    mask = _random_masks(b, b)
    parent = np.zeros(mask.shape[:2], np.int32)   # a collapsed level
    got = tbh._octet_keys_children(torch.from_numpy(mask),
                                   torch.from_numpy(parent), 7, b).numpy()
    assert got.shape == mask.shape[:2] + (-(-b // 8),)
    want = {tuple(int(v) for v in t) for t in zip(*np.nonzero(mask))}
    assert _decode(got, 7) == want
    jax_keys = np.asarray(jbh._octet_keys_children(
        jnp.asarray(mask), jnp.asarray(parent), 7, b))[..., None]
    assert _decode(jax_keys, 7) != want


def _rank_layout(n_ranks, n_local, leaves_per_rank, seed):
    """The JAX package's seeded Plummer particles in curve order, cut into
    n_ranks contiguous ranges of n_local, each padded with zero-mass
    sentinel rows to leaves_per_rank * LEAF (the owned layout of a
    distributed tree). Returns (pos_s, mass_s, sentinel, pos, mass);
    pos/mass unpadded, in input order."""
    n = n_ranks * n_local
    cfg = JaxConfig(n=n, ic="plummer", dtype="float32")
    pos, _, mass = (torch.from_numpy(np.array(a)) for a in
                    jmodels.get_ic("plummer")(jax.random.key(seed), cfg))
    lo, hi = torch.amin(pos, 0), torch.amax(pos, 0)
    center, half, sentinel = tbh.domain_cube(lo, hi)
    order = torch.sort(hilbert_encode(pos, center, half), stable=True).indices
    cap = leaves_per_rank * LEAF
    pos_s = sentinel.repeat(n_ranks * cap, 1)
    mass_s = torch.zeros(n_ranks * cap, dtype=torch.float32)
    for k in range(n_ranks):
        rows = order[k * n_local:(k + 1) * n_local]
        pos_s[k * cap:k * cap + n_local] = pos[rows]
        mass_s[k * cap:k * cap + n_local] = mass[rows]
    return pos_s, mass_s, sentinel, pos, mass


SHAPES = {"4x40": (4, 1024, 40, (160, 20, 1)),
          "8x10": (8, 256, 10, (80, 10, 1))}


@pytest.fixture(scope="module", params=list(SHAPES))
def staged_shape(request):
    n_ranks, n_local, per_rank, widths = SHAPES[request.param]
    pos_s, mass_s, sentinel, pos, mass = _rank_layout(n_ranks, n_local,
                                                      per_rank, 0)
    tree = tbh.build_tree(pos_s, mass_s, LEAF, sentinel, multipole_order=2)
    assert tuple(c.shape[0] for c in tree.com) == widths
    s = dict(name=request.param)
    n_leaves = widths[0]
    fm, rej = tbh.traverse(tree, THETA, stop_level=2)
    _, cands = tbh.resolve_refine("staged", (0, 0), tree.n_levels,
                                  n_leaves, n_leaves)
    kw = dict(theta=THETA, start_leaf=0, n_slice=n_leaves,
              near_budget=n_leaves, far_budget=4 * n_leaves,
              cand2_budget=cands[0], cand1_budget=cands[1],
              dtype=torch.float32)
    octet = tbh.build_interaction_lists_staged(tree, fm, rej,
                                               octet_far=True, **kw)
    gather = tbh.build_interaction_lists_staged(tree, fm, rej, **kw)
    return s | dict(tree=tree, fm=fm, rej=rej, cands=cands, octet=octet,
                    gather=gather, pos_s=pos_s, mass_s=mass_s, pos=pos,
                    mass=mass, n_leaves=n_leaves)


def _node_sets_octet(tree, keys, valid):
    widths = [c.shape[0] for c in tree.com]
    offs8, _ = tbh._octet_offsets(widths)
    rows = []
    for kr, vr in zip(keys.numpy(), valid.numpy()):
        s = []
        for key in kr[vr]:
            oct_id = int(key) >> 8
            k = max(i for i in range(len(offs8)) if offs8[i] <= oct_id)
            for bit in range(8):
                if int(key) >> bit & 1:
                    s.append((k, (oct_id - offs8[k]) * 8 + bit))
        rows.append(sorted(s))
    return rows


def _node_sets_gather(tree, idx, valid):
    offs = tbh._level_offsets([c.shape[0] for c in tree.com])
    rows = []
    for ir, vr in zip(idx.numpy(), valid.numpy()):
        s = []
        for g in ir[vr]:
            k = max(i for i in range(len(offs)) if offs[i] <= int(g))
            s.append((k, int(g) - offs[k]))
        rows.append(sorted(s))
    return rows


def test_octet_list_names_the_gather_list(staged_shape):
    s = staged_shape
    ni, nv, fk, fv, nodes8, of = s["octet"]
    gni, gnv, gi, gv, nodes_all, gof = s["gather"]
    assert int(of) == int(gof) == 0
    np.testing.assert_array_equal(ni.numpy(), gni.numpy())
    np.testing.assert_array_equal(nv.numpy(), gnv.numpy())
    octet_sets = _node_sets_octet(s["tree"], fk, fv)
    assert octet_sets == _node_sets_gather(s["tree"], gi, gv)
    # At 4 x 40 the root's children past its first octet are accepted for
    # some targets (the keys the JAX package sends to another octet); at
    # 8 x 10 no level-1 node is accepted on these particles.
    level1 = {i for row in octet_sets for k, i in row if k == 1}
    assert (max(level1, default=-1) >= 8) == (s["name"] == "4x40")


def _forces(s, far_mode):
    setup = tbh.BHSetup.make(
        n_leaves=s["n_leaves"], leaf_size=LEAF, theta=THETA, softening=0.01,
        near_budget=s["n_leaves"], far0_budget=4 * s["n_leaves"],
        compute_pot=False, refine="staged", cand_budgets=s["cands"],
        far_mode=far_mode)
    acc, _, of = tbh._forces_sorted(
        s["pos_s"], s["mass_s"], s["tree"], s["fm"], s["rej"], setup,
        start_leaf=0, n_slice=s["n_leaves"])
    assert int(of) == 0
    return acc


def _rel(a, b):
    return float(torch.sqrt(torch.sum((a - b) ** 2))
                 / torch.sqrt(torch.sum(b * b)))


def test_octet_forces_equal_gather_and_direct(staged_shape):
    s = staged_shape
    octet, gather = _forces(s, "octet"), _forces(s, "gather")
    assert _rel(octet, gather) < GATHER_OCTET
    # The far terms counted: the octet keys' children against the gather
    # list's entries.
    _, _, fk, fv, _, _ = s["octet"]
    bits = torch.stack([(fk >> b) & 1 for b in range(8)]).sum(0)
    assert int(torch.sum(torch.where(fv, bits, 0))) == int(
        torch.sum(s["gather"][3]))
    live = s["mass_s"] > 0
    ref, _ = direct_accel(s["pos"].double(), s["mass"].double(), g=1.0,
                          softening=0.01)
    # Sorted live rows back in input order: match each by position.
    pos_live = s["pos_s"][live]
    order = torch.argsort(_input_rows(pos_live, s["pos"]))
    for acc in (octet, gather):
        a = acc[live][order].double()
        err = torch.sqrt(torch.mean(torch.sum((a - ref) ** 2, 1)))
        den = torch.sqrt(torch.mean(torch.sum(ref ** 2, 1)))
        assert float(err / den) < RMS_CLASS


def _input_rows(pos_live, pos):
    """For each sorted live row, the input row holding the same particle
    (positions are distinct), so pos[key] == pos_live."""
    index = {tuple(p): i for i, p in enumerate(pos.numpy().tolist())}
    return torch.tensor([index[tuple(p)] for p in pos_live.numpy().tolist()])
