"""K1's work items (ops/bh_kernels.near_items) and the chunked sums they
stand for, on the CPU.

The kernel cuts every near-list row into items of at most C entries, runs
the items longest first, and adds a split row's partial sums in chunk
order (csrc/near_field.cu). Here: the items cover every live (row, entry)
exactly once, in list order within a row, no item is longer than C, and the
partial sums of the items, added in chunk order, equal near_field_plain on
the port's own lists. Tolerance rtol 2e-4, atol 2e-5 (the bound of the
kernel parity tests): the same f32 terms, added in another order.
"""

import numpy as np
import pytest
import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh, bh_kernels

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
BUDGET = 1536


def _counts(case, chunk):
    rng = np.random.default_rng(7)
    short = rng.integers(1, 3 * chunk, size=24)
    if case == "empty_rows":
        counts = np.where(rng.random(24) < 0.4, 0, short)
    elif case == "exactly_C":
        counts = np.concatenate([[chunk], short, [chunk, chunk - 1,
                                                  chunk + 1]])
    elif case == "longer_than_10C":  # the N = 1M t = 0 lists' longest row
        counts = np.concatenate([short[:12], [1164], short[12:]])
    else:                            # budget_full
        counts = np.concatenate([np.full(5, BUDGET), short[:3]])
    return torch.from_numpy(counts.astype(np.int64))


@pytest.mark.parametrize("chunk", [bh_kernels.NEAR_CHUNK, 7])
@pytest.mark.parametrize("case", ["empty_rows", "exactly_C",
                                  "longer_than_10C", "budget_full"])
def test_near_items_cover_each_entry_once(case, chunk):
    counts = _counts(case, chunk)
    items, splits, n_partial = bh_kernels.near_items(counts, chunk)
    assert items.dtype == splits.dtype == torch.int32
    rows, begin, end, dst = (c.long() for c in items.unbind(1))
    length = end - begin
    assert bool((length >= 0).all()) and bool((length <= chunk).all())
    assert bool((length[:-1] >= length[1:]).all())       # longest first

    covered = torch.zeros((counts.shape[0], BUDGET), dtype=torch.int64)
    for r, b, e in zip(rows.tolist(), begin.tolist(), end.tolist()):
        covered[r, b:e] += 1
    live = torch.arange(BUDGET)[None, :] < counts[:, None]
    assert torch.equal(covered, live.long())             # each entry once

    n_items = torch.bincount(rows, minlength=counts.shape[0])
    want = torch.clamp((counts + chunk - 1) // chunk, min=1)
    assert torch.equal(n_items, want)                    # empty rows: one
    single = want[rows] == 1
    assert bool((dst[single] == -1).all())
    assert bool((dst[~single] >= 0).all())

    # A split row's partial slots run in list order, back to back.
    assert splits.shape[0] == int((want > 1).sum())
    assert n_partial == int(want[want > 1].sum())
    seen = []
    for row, first, n in splits.long().tolist():
        assert n == int(want[row]) > 1
        mine = (rows == row).nonzero().reshape(-1)
        by_slot = mine[torch.argsort(dst[mine])]
        assert torch.equal(dst[by_slot], torch.arange(first, first + n))
        assert torch.equal(begin[by_slot], torch.arange(n) * chunk)
        assert int(end[by_slot[-1]]) == int(counts[row])
        seen.extend(range(first, first + n))
    assert sorted(seen) == list(range(n_partial))


@pytest.fixture(scope="module")
def lists():
    """The port's dense-octet near lists at N = 2048, leaf 32, theta 0.6,
    on the CPU."""
    cfg = SimConfig(n=2048, ic="plummer", seed=5)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=32, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // 32
    far, rej = bh.traverse(tree, 0.6)
    ni, nv, *_, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=0.6, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0
    return pos_s, mass_s, pos_s.reshape(n_leaves, 32, 3), ni, nv


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_chunked_sums_match_near_field_plain(lists, softening, compute_pot):
    """Each item's sum over its own entries (near_field_plain on a one-item
    list), added in chunk order where a row is split, equals the row's
    near field."""
    pos_s, mass_s, tgt, idx, valid = lists
    chunk = 3
    counts = valid.sum(1)
    assert int(counts.max()) > 3 * chunk      # rows split into 4+ items
    items, splits, _ = bh_kernels.near_items(counts, chunk)
    rows, begin, end, dst = (c.long() for c in items.unbind(1))
    cols = begin[:, None] + torch.arange(chunk)[None, :]
    item_valid = cols < end[:, None]
    item_idx = torch.where(item_valid, idx[rows[:, None], cols.clamp(
        max=idx.shape[1] - 1)], 0).to(torch.int32)
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    part_acc, part_pot = bh_kernels.near_field_plain(
        pos_s, mass_s, tgt[rows], item_idx, item_valid, **kw)
    G = tgt.shape[1]
    part_acc = part_acc.reshape(-1, G, 3)
    part_pot = part_pot.reshape(-1, G)

    acc = torch.full((tgt.shape[0], G, 3), float("nan"))
    pot = torch.full((tgt.shape[0], G), float("nan"))
    direct = dst < 0
    acc[rows[direct]] = part_acc[direct]
    pot[rows[direct]] = part_pot[direct]
    slot_item = torch.empty(int(dst.max()) + 1, dtype=torch.long)
    slot_item[dst[~direct]] = torch.nonzero(~direct).reshape(-1)
    for row, first, n in splits.long().tolist():
        a, p = part_acc[slot_item[first]], part_pot[slot_item[first]]
        for c in range(1, n):
            a = a + part_acc[slot_item[first + c]]
            p = p + part_pot[slot_item[first + c]]
        acc[row], pot[row] = a, p

    want_acc, want_pot = bh_kernels.near_field_plain(pos_s, mass_s, tgt, idx,
                                                     valid, **kw)
    np.testing.assert_allclose(acc.reshape(-1, 3).numpy(), want_acc.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pot.reshape(-1).numpy(), want_pot.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_near_work_is_built_for_card_lists_only(lists):
    """near_work (the items the paths build next to the lists) is None for
    CPU lists, whose plain version needs no items; near_field on the CPU
    gives the same sums with or without it."""
    pos_s, mass_s, tgt, idx, valid = lists
    assert bh_kernels.near_work(valid) is None
    kw = dict(g=1.0, softening=0.02)
    work = bh_kernels.near_items(valid.sum(1), bh_kernels.NEAR_CHUNK)
    for a, b in zip(bh_kernels.near_field(pos_s, mass_s, tgt, idx, valid,
                                          **kw),
                    bh_kernels.near_field(pos_s, mass_s, tgt, idx, valid,
                                          work=work, **kw)):
        assert torch.equal(a, b)
