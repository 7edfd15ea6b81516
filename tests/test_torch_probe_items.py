"""The work items of K8 (`near_probe.probe_items`) and K11
(`near_flat.lane_items`), and the order in which the kernels add the sums
they stand for, on the CPU.

K8's kernel cuts each (row, segment) run of list positions into items of
at most C entries and K11's each row's steps into items of at most
`lane_chunk` steps, both through `bh_kernels.near_items`, heaviest first,
one block each (csrc/near_probe.cu, csrc/near_flat.cu). Here: the items
cover every live (row, entry) or (row, step) exactly once, inside its
segment, no item is longer than C, and the items' sums added in the
kernels' order (numpy-seeded lists whose rows are many times C long)
reproduce the plain versions.

The kernels' order, written out in torch: K8 sums each tile on its own
and adds it into the item's carry, adds a split row's item carries in
chunk order, and writes the row in segment 0 and adds to it after; K11
keeps one sum per slice of 32 of a pack's 128 lanes, reduces the slices in
order once a step ("step", into the item's sum) or at the item's end
("row"), and adds a split row's item sums in item order. Tolerance: the
same f32 terms in another order, |order - plain| <= 1e-5 of the row's
largest |value| (the kernels are held to rtol 2e-4 / atol 2e-5 on the
card, tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

from parallelnbody_tpu_torch.ops import bh_kernels, near_flat, near_probe

torch.set_num_threads(2)

RTOL = 1e-5
INT32_MAX = np.iinfo(np.int32).max
LEAVES, G, BUDGET = 32, 32, 32


def _lists(seed=0):
    """torch (tgt_t (L, 4, G), table (L, 4, G), idx (L, B), valid (L, B)):
    ascending front-packed lists of up to all 32 leaves, rows with no
    entry in some segment, one row with none at all."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(LEAVES, G, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, size=(LEAVES, G, 1)).astype(np.float32) \
        / (LEAVES * G)
    table = np.concatenate([pos, mass], axis=2).transpose(0, 2, 1)
    tgt_t = np.concatenate([pos, np.zeros_like(mass)], axis=2).transpose(
        0, 2, 1)
    counts = rng.integers(1, LEAVES + 1, LEAVES)
    counts[:4] = (LEAVES, LEAVES - 1, 0, 3)
    idx = np.full((LEAVES, BUDGET), INT32_MAX, np.int32)
    for t, c in enumerate(counts):
        idx[t, :c] = np.sort(rng.choice(LEAVES, c, replace=False))
    idx[3, :3] = (0, 1, 2)                 # no entry past segment 0
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (tgt_t, table, idx, idx != INT32_MAX))


def _covered(items, n_rows, width):
    """(n_rows, width) how often each (row, position) is in an item."""
    out = torch.zeros((n_rows, width), dtype=torch.int64)
    for r, b, e, _ in items.tolist():
        out[r, b:e] += 1
    return out


def _check_items(work, chunk, counts, lo, width, every_row):
    """One NearWork over runs [lo, lo + counts) of each row."""
    items, splits, n_partial = work
    rows, begin, end, dst = (c.long() for c in items.unbind(1))
    length = end - begin
    assert bool((length >= 0).all()) and bool((length <= chunk).all())
    assert bool((length[:-1] >= length[1:]).all())        # heaviest first
    pos = torch.arange(width)[None, :]
    live = (pos >= lo[:, None]) & (pos < (lo + counts)[:, None])
    assert torch.equal(_covered(items, counts.shape[0], width), live.long())
    n_items = torch.bincount(rows, minlength=counts.shape[0])
    if every_row:
        assert bool((n_items >= 1).all())
    else:
        assert torch.equal(n_items, (counts + chunk - 1) // chunk)
    # A split row's items write partial slots first.. in chunk order.
    assert int((dst >= 0).sum()) == n_partial
    for row, first, n in splits.tolist():
        mine = (rows == row).nonzero().squeeze(1)
        order = mine[torch.argsort(begin[mine])]
        assert dst[order].tolist() == list(range(first, first + n))
    assert bool((dst[n_items[rows] == 1] == -1).all())


@pytest.mark.parametrize("chunk", [bh_kernels.NEAR_CHUNK, 5, 3])
@pytest.mark.parametrize("segments", [1, 4])
def test_probe_items_cover_each_segment_run_once(segments, chunk):
    """Each (row, segment) run [bnd[t, s], bnd[t, s + 1]) is covered by
    exactly one item per entry, no item crosses a segment edge (chunk 5
    and 3 do not divide the runs), segment 0 gives every row an item."""
    _, _, idx, valid = _lists()
    rows_per_seg = LEAVES // segments
    bnd = near_probe.probe_bounds(idx, valid, rows_per_seg)
    items = near_probe.probe_items(bnd, chunk)
    assert len(items) == segments
    for s, work in enumerate(items):
        counts = (bnd[:, s + 1] - bnd[:, s]).long()
        _check_items(work, chunk, counts, bnd[:, s].long(), BUDGET,
                     every_row=s == 0)
        assert work.every_row == (s == 0)


def _probe_in_item_order(tgt_t, table, idx, valid, mode, rows_per_seg,
                         items, eps2=near_probe.EPS2):
    """K8's sums in the kernel's order over `items` (probe_items)."""
    tgt = tgt_t[:, :3].transpose(1, 2)                      # (L, G, 3)
    src = table.transpose(1, 2)                             # (L, G, 4)
    out = torch.zeros_like(tgt_t)
    for s, (its, splits, n_partial) in enumerate(items):
        base = s * rows_per_seg
        partial = torch.zeros((max(n_partial, 1), G, 3))
        for row, b, e, dst in its.tolist():
            carry = torch.zeros((G, 3))
            for k in range(b, e):
                leaf = {"A": int(idx[row, k]),
                        "B": base + k % rows_per_seg, "C": base}[mode]
                p = src[leaf]
                d = p[None, :, :3] - tgt[row][:, None, :]
                r2 = (d * d).sum(-1) + eps2
                u = torch.rsqrt(r2)
                w = (p[None, :, 3] * u) * (u * u)
                carry = carry + (w[..., None] * d).sum(1)
            if dst < 0:
                out[row, :3] = (out[row, :3] + carry.T) if s else carry.T
            else:
                partial[dst] = carry
        for row, first, n in splits.tolist():
            total = partial[first]
            for c in range(1, n):
                total = total + partial[first + c]
            out[row, :3] = (out[row, :3] + total.T) if s else total.T
    return out


def _assert_rows_close(got, want):
    got, want = got.double(), want.double()
    scale = want.abs().reshape(want.shape[0], -1).amax(1)
    err = (got - want).abs().reshape(want.shape[0], -1).amax(1)
    assert bool((err <= RTOL * scale + 1e-30).all()), float(
        (err / scale.clamp_min(1e-30)).max())


@pytest.mark.parametrize("mode", ["A", "B", "C"])
@pytest.mark.parametrize("segments", [1, 4])
def test_probe_item_order_reproduces_the_plain_version(mode, segments):
    """Items of 3 entries on rows of up to 32 (10 items and more), the
    partials added in chunk order, the segments written then added: the
    plain version's sums (E computes A's function)."""
    args = _lists(seed=1)
    rows_per_seg = LEAVES // segments
    bnd = near_probe.probe_bounds(args[2], args[3], rows_per_seg)
    items = near_probe.probe_items(bnd, 3)
    assert max(int(w.items[:, 0].bincount().max()) for w in items) >= 3
    got = _probe_in_item_order(*args, mode, rows_per_seg, items)
    want = near_probe.near_probe_plain(*args, mode=mode, unroll=4,
                                       rows_per_seg=rows_per_seg)
    _assert_rows_close(got, want)


def _steps(seed=0, n_rows=12):
    """numpy-seeded rows (S,) int32 of 1 to 40 steps each, the first 40."""
    rng = np.random.default_rng(seed)
    per_row = rng.integers(1, 41, n_rows)
    per_row[0] = 40
    return torch.from_numpy(np.repeat(np.arange(n_rows), per_row).astype(
        np.int32)), per_row


def test_lane_chunk_is_k1s_item():
    assert [near_flat.lane_chunk(p) for p in near_flat.STEP_PACKS] == \
        [16, 8, 4]
    for p in near_flat.STEP_PACKS:
        assert near_flat.lane_chunk(p) * p * near_flat.LANES == \
            bh_kernels.NEAR_CHUNK * 256


@pytest.mark.parametrize("packs", near_flat.STEP_PACKS)
def test_lane_items_cover_each_rows_steps_once(packs):
    """Each row's steps [starts[r], starts[r + 1]) are covered by exactly
    one item per step, items of at most lane_chunk steps, heaviest
    first."""
    rows, per_row = _steps()
    starts = near_flat.row_starts(rows, len(per_row))
    work = near_flat.lane_items(rows, len(per_row), packs)
    counts = torch.from_numpy(per_row).long()
    _check_items(work, near_flat.lane_chunk(packs), counts,
                 starts[:-1].long(), rows.shape[0], every_row=True)
    with pytest.raises(ValueError, match="ascend"):
        near_flat.lane_items(rows.flip(0).contiguous(), len(per_row), packs)


def _lanes_in_item_order(rows, tgt_t, src, mode, work, eps2):
    """K11's sums in the kernel's order over `work` (items over steps)."""
    tgt = tgt_t[:, :3].transpose(1, 2)                       # (Ls, G, 3)
    out = torch.zeros_like(tgt_t)
    items, splits, n_partial = work
    partial = torch.zeros((max(n_partial, 1), tgt.shape[1], 4))
    for row, b, e, dst in items.tolist():
        acc = torch.zeros((tgt.shape[1], 4))
        slices = torch.zeros((tgt.shape[1], 4, 4))          # (G, slice, 4)
        for c in range(b, e):
            for p in range(src.shape[1]):
                terms = near_flat._terms(tgt[row][None], src[c, p][None],
                                         eps2, False, True)[0]
                slices = slices + terms.reshape(-1, 4, 32, 4).sum(2)
            if mode == "step":
                acc = acc + slices.sum(1)
                slices = torch.zeros_like(slices)
        if mode == "row":
            acc = slices[:, 0] + slices[:, 1] + slices[:, 2] + slices[:, 3]
        if dst < 0:
            out[row] = acc.T
        else:
            partial[dst] = acc
    for row, first, n in splits.tolist():
        total = partial[first]
        for c in range(1, n):
            total = total + partial[first + c]
        out[row] = total.T
    return out


@pytest.mark.parametrize("mode", near_flat.LANE_MODES)
def test_lane_item_order_reproduces_the_plain_version(mode):
    """Items of 2 steps on rows of up to 40 steps at 4 packs (20 items
    and more), slices of 32 lanes, the item sums added in item order: the
    plain version's sums."""
    rows, per_row = _steps(seed=2, n_rows=6)
    rng = np.random.default_rng(3)
    tgt_t = torch.from_numpy(rng.normal(size=(6, 4, 32)).astype(np.float32))
    src = rng.normal(size=(rows.shape[0], 4, 4, 128)).astype(np.float32)
    src[:, :, 3] = np.abs(src[:, :, 3])
    src = torch.from_numpy(src)
    starts = near_flat.row_starts(rows, 6)
    work = bh_kernels.near_items(starts[1:] - starts[:-1], 2,
                                 lo=starts[:-1])
    got = _lanes_in_item_order(rows, tgt_t, src, mode, work,
                               near_flat.TUNE_EPS2)
    want = near_flat.flat_tune2_plain(rows, tgt_t, src, step_packs=4,
                                      mode=mode)
    _assert_rows_close(got, want)
