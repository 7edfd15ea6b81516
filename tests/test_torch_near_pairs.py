"""K1's mutual form (ops/bh_kernels.near_pairs): the pairing of mirror
entries in whole-set near lists, and the items, slots and combining order
that carry each mutual leaf pair's sums to both leaves, on the CPU.

A live entry (t, s) is mutual where t != s and t is in s's list too; the
copy with t < s is evaluated once for both leaves and its mirror dropped.
Here: every live ordered entry is served exactly once (one-way in its row,
or as one direction of a kept pair); a pair is mutual only where both
directions are listed; hand-built symmetric lists are all mutual but the
self entries and one-sided lists all one-way; the sums that the items,
slots and splits stand for, added in the kernel's order, equal
near_field_plain; and the window and table forms' items (near_items) are
what they were, item for item. Tolerance rtol 2e-4, atol 2e-5 (the kernel
parity tests'): the same f32 terms, added in another order.
"""

import numpy as np
import pytest
import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh, bh_kernels

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


def _sphere_lists(kind, leaf, n=4096, seed=11, theta=0.6):
    """Sorted particles and whole-set near lists (dense octet or staged)
    of a seeded Plummer sphere at the given leaf size, on the CPU."""
    cfg = SimConfig(n=n, ic="plummer", seed=seed)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // leaf
    widths = [c.shape[0] for c in tree.com]
    if kind == "staged":
        far, rej = bh.traverse(tree, theta, stop_level=2)
        ni, nv, *_, of = bh.build_interaction_lists_staged(
            tree, far, rej, theta=theta, start_leaf=0, n_slice=n_leaves,
            near_budget=n_leaves, far_budget=2 * n_leaves,
            cand2_budget=widths[2], cand1_budget=widths[1],
            dtype=torch.float32, octet_far=True)
    else:
        far, rej = bh.traverse(tree, theta)
        ni, nv, *_, of = bh.build_interaction_lists_octet(
            tree, far, rej, theta=theta, start_leaf=0, n_slice=n_leaves,
            near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0
    return pos_s, mass_s, pos_s.reshape(n_leaves, leaf, 3), ni, nv


@pytest.fixture(scope="module", params=[("dense", 16), ("dense", 32),
                                        ("staged", 16), ("staged", 64)],
                ids=lambda p: f"{p[0]}-leaf{p[1]}")
def sphere(request):
    return _sphere_lists(*request.param)


def _served(work):
    """{(t, s): times served} from a mutual work: each one-way entry once
    for (t, s), each kept mutual entry once for (t, s) and once for its
    mirror (s, t); and the kept pairs."""
    srcs = work.srcs.long()
    served, kept = {}, []
    for items, mutual in ((work.items, False), (work.pairs, True)):
        for row, begin, end, _ in items.long().tolist():
            for s in srcs[begin:end].tolist():
                served[(row, s)] = served.get((row, s), 0) + 1
                if mutual:
                    served[(s, row)] = served.get((s, row), 0) + 1
                    kept.append((row, s))
    return served, kept


def _listed(idx, valid):
    return {(t, int(s)) for t in range(idx.shape[0])
            for s in idx[t][valid[t]].tolist()}


def test_each_live_entry_is_served_once(sphere):
    *_, idx, valid = sphere
    work = bh_kernels.near_pairs(idx, valid)
    served, kept = _served(work)
    listed = _listed(idx, valid)
    assert set(served) == listed
    assert all(n == 1 for n in served.values())
    assert work.entries == len(listed)
    assert work.sym_entries == len(kept) > 0
    # The pairing does its work: most entries come in mirror pairs here.
    assert 2 * len(kept) > 0.5 * len(listed)


def test_a_pair_is_mutual_only_where_both_are_listed(sphere):
    *_, idx, valid = sphere
    work = bh_kernels.near_pairs(idx, valid)
    _, kept = _served(work)
    listed = _listed(idx, valid)
    assert all(t < s and (s, t) in listed for t, s in kept)
    # ... and every mirror pair of the lists is kept.
    both = {(t, s) for t, s in listed if t < s and (s, t) in listed}
    assert set(kept) == both


def test_items_slots_and_splits(sphere):
    """Items of one kind each, at most NEAR_CHUNK entries, longest first;
    each row's slot block is its one-way items', its mutual items', then
    one slot a mutual entry that names it, in ascending partner order, and
    every slot is written once."""
    *_, idx, valid = sphere
    work = bh_kernels.near_pairs(idx, valid)
    chunk = bh_kernels.NEAR_CHUNK
    writes = torch.zeros(work.n_partial, dtype=torch.int64)
    blocks = {row: (first, n) for row, first, n in work.splits.tolist()}
    for items in (work.items, work.pairs):
        length = (items[:, 2] - items[:, 1]).long()
        assert bool((length <= chunk).all())
        assert bool((length[:-1] >= length[1:]).all())
        for row, _, _, dst in items.tolist():
            if dst < 0:
                assert row not in blocks
            else:
                first, n = blocks[row]
                assert first <= dst < first + n
                writes[dst] += 1
    srcs, slot_of = work.srcs.long(), work.slot_of.long()
    incoming = {}
    for row, begin, end, _ in work.pairs.tolist():
        for k in range(begin, end):
            incoming.setdefault(int(srcs[k]), []).append(
                (row, int(slot_of[k])))
            writes[slot_of[k]] += 1
    assert bool((writes == 1).all())
    for row, (first, n) in blocks.items():
        own = n - len(incoming.get(row, []))
        partners = sorted(incoming.get(row, []))
        assert [slot for _, slot in partners] == list(range(first + own,
                                                           first + n))
    assert sum(n for _, n in blocks.values()) == work.n_partial


def _pair_sums(pos_s, mass_s, tgt, work, **kw):
    """The mutual form's output, in plain torch: each item's sums (a kept
    entry's source side from the mirror's one-way terms) into its slot or
    its row, then each split row's slots added in order."""
    n_leaves, G, _ = tgt.shape
    srcs = work.srcs.long()
    slots = torch.full((work.n_partial, G, 4), float("nan"))
    acc = torch.full((n_leaves, G, 3), float("nan"))
    pot = torch.full((n_leaves, G), float("nan"))

    def one(rows, sources):
        """near_field_plain of target leaves `rows`, each against its
        source leaves `sources` (a list of lists)."""
        width = max(1, max(len(s) for s in sources))
        idx = torch.zeros((len(rows), width), dtype=torch.int32)
        valid = torch.zeros((len(rows), width), dtype=torch.bool)
        for r, s in enumerate(sources):
            idx[r, :len(s)] = torch.tensor(s, dtype=torch.int32)
            valid[r, :len(s)] = True
        a, p = bh_kernels.near_field_plain(pos_s, mass_s, tgt[rows], idx,
                                           valid, **kw)
        return torch.cat([a.reshape(-1, G, 3), p.reshape(-1, G, 1)], -1)

    for items in (work.items, work.pairs):
        if items.shape[0] == 0:
            continue
        rows = items[:, 0].long()
        sums = one(rows, [srcs[b:e].tolist() for _, b, e, _ in
                          items.tolist()])
        for k, (row, _, _, dst) in enumerate(items.tolist()):
            if dst < 0:
                acc[row], pot[row] = sums[k, :, :3], sums[k, :, 3]
            else:
                slots[dst] = sums[k]
    for row, begin, end, _ in work.pairs.tolist():
        for k in range(begin, end):
            slots[work.slot_of[k]] = one([int(srcs[k])], [[row]])[0]
    for row, first, n in work.splits.tolist():
        s = slots[first]
        for c in range(1, n):
            s = s + slots[first + c]
        acc[row], pot[row] = s[:, :3], s[:, 3]
    return acc.reshape(-1, 3), pot.reshape(-1)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_pair_sums_match_near_field_plain(softening, compute_pot):
    pos_s, mass_s, tgt, idx, valid = _sphere_lists("staged", 16, n=2048)
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    work = bh_kernels.near_pairs(idx, valid, chunk=5)
    assert work.pairs.shape[0] > 0 and work.splits.shape[0] > 0
    acc, pot = _pair_sums(pos_s, mass_s, tgt, work, **kw)
    want_acc, want_pot = bh_kernels.near_field_plain(pos_s, mass_s, tgt, idx,
                                                     valid, **kw)
    np.testing.assert_allclose(acc.numpy(), want_acc.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pot.numpy(), want_pot.numpy(), rtol=RTOL,
                               atol=ATOL)


def _lists(rows, budget):
    idx = torch.zeros((len(rows), budget), dtype=torch.int32)
    valid = torch.zeros((len(rows), budget), dtype=torch.bool)
    for t, r in enumerate(rows):
        idx[t, :len(r)] = torch.tensor(sorted(r), dtype=torch.int32)
        valid[t, :len(r)] = True
    return idx, valid


@pytest.mark.parametrize("chunk", [bh_kernels.NEAR_CHUNK, 2])
def test_symmetric_lists_are_mutual_but_the_self_entries(chunk):
    gen = torch.Generator().manual_seed(3)
    n = 40
    near = torch.rand((n, n), generator=gen) < 0.3
    near = near | near.T | torch.eye(n, dtype=torch.bool)
    idx, valid = _lists([torch.nonzero(r).reshape(-1).tolist()
                         for r in near], n + 3)
    work = bh_kernels.near_pairs(idx, valid, chunk=chunk)
    srcs = work.srcs.long()
    one_way = [(row, int(s)) for row, b, e, _ in work.items.tolist()
               for s in srcs[b:e]]
    assert sorted(one_way) == [(t, t) for t in range(n)]
    assert work.sym_entries == (int(near.sum()) - n) // 2
    assert work.entries == int(near.sum())


def test_one_sided_lists_are_one_way():
    n = 30
    rows = [[t] + [s for s in range(t + 1, n) if (s * 7 + t) % 3 == 0]
            for t in range(n)]
    idx, valid = _lists(rows, n)
    work = bh_kernels.near_pairs(idx, valid)
    assert work.pairs.shape[0] == 0 and work.sym_entries == 0
    assert work.splits.shape[0] == 0 and work.n_partial == 0
    assert bool((work.items[:, 3] == -1).all())
    served, _ = _served(work)
    assert set(served) == _listed(idx, valid)


def test_pair_targets():
    """One warp a block: the fewest targets a thread that fit the leaf;
    none above PAIR_LEAF_MAX."""
    assert [bh_kernels.pair_targets(g) for g in (16, 32, 33, 64, 100, 128,
                                                 256, 257, 512)] == \
        [1, 1, 2, 2, 4, 4, 8, 0, 0]
    assert bh_kernels.pair_targets(bh_kernels.PAIR_LEAF_MAX) == 8


def _items_ref(counts, chunk, lo, every_row):
    """near_items' items by their definition, row by row: (rows, begin,
    end, dst) longest first, a stable order."""
    out, slot = [], 0
    for row, c in enumerate(counts.tolist()):
        n = -(-c // chunk)
        if every_row:
            n = max(n, 1)
        start = 0 if lo is None else int(lo[row])
        for k in range(n):
            dst = slot + k if n > 1 else -1
            out.append((row, start + k * chunk,
                        start + min(k * chunk + chunk, c), dst))
        slot += n if n > 1 else 0
    out.sort(key=lambda it: -(it[2] - it[1]))
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 4)


@pytest.mark.parametrize("form", ["window", "table", "shaped"])
def test_window_and_table_items_are_unchanged(sphere, form):
    """The window and table forms keep the one-way items, item for item."""
    *_, idx, valid = sphere
    n_leaves = idx.shape[0]
    if form == "table":
        edges, kw = [0, n_leaves // 2], dict(chunk=bh_kernels.NEAR_CHUNK)
    elif form == "window":
        edges = [0, n_leaves // 3, n_leaves]
        kw = dict(chunk=bh_kernels.NEAR_CHUNK, writes=(0,))
    else:
        edges = [0, n_leaves // 4, n_leaves]
        kw = dict(leaf_size=128, n_sm=132)
    works = bh_kernels.near_windows(idx, valid, edges, **kw)
    for w, work in enumerate(works):
        lo = torch.sum(valid & (idx < edges[w]), dim=1)
        hi = torch.sum(valid & (idx < edges[w + 1]), dim=1)
        every_row = "writes" not in kw or w in kw["writes"]
        want = _items_ref(hi - lo, work.chunk, lo, every_row)
        assert torch.equal(work.items, want)
        assert work.pairs is None and work.srcs is None
        assert work.sym_entries == 0
