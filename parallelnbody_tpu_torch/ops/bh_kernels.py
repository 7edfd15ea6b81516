"""The Barnes-Hut list kernels: K1 (near field), K2 (octet far field) and
K4 (far field over lists of node rows).

Counterpart of `parallelnbody_tpu/ops/pallas_bh.py`:

  * `near_field` replaces `_near_table_kernel` (pallas_bh.py:179, called
    through `near_field_pallas`), source csrc/near_field.cu;
  * `far_octet` replaces `_far_octet_kernel` (pallas_bh.py:382, called
    through `far_octet_pallas`), source csrc/far_octet.cu;
  * `far_gather` replaces `_gathered_kernel` (pallas_bh.py:41, called
    through `_gathered_call`, `_far_eval` and `far_field_pallas`), source
    csrc/far_gather.cu.

K1 has three entry forms, as `near_field_pallas` has: the unwindowed form
over all sorted particles; the window form (`leaf_lo=`), whose sources are a
shard of the sorted particles holding the leaves [leaf_lo, leaf_lo +
n_shard_leaves), list entries outside the window skipped (the ring near
field of parallel/distributed.py); and the table form (`src_table=`), a
prebuilt packed (n_rows * G, 4) [x, y, z, m] source table, entries past its
last row skipped (the LET near field). Each form has its own launch count.
On lists that cover every leaf and whose targets are the sources, the
unwindowed form evaluates each mutual leaf pair once for both leaves
(`near_pairs`, Newton's third law); the other forms, and target windows
of a sectioned evaluation, keep the one-way form.

All three return the list sums scaled as the JAX package's `_unpack` does:
acc = g * [sum w dx, sum w dy, sum w dz] and pot = -g * sum m u, with
u = rsqrt(r^2 + eps^2) and w = m u^3 (plus the traceless quadrupole terms in
the far field). guard_zero (softening 0) zeroes u where r^2 = 0;
compute_pot=False returns a zero potential.

Each wrapper dispatches on the device of the tensors it is given: on the CPU
it runs its plain PyTorch version (`near_field_plain`, `far_octet_plain`,
`far_gather_plain`, ports of `_near_field_jnp`, `_far0_jnp`,
`_far_octet_jnp` and the jnp branch of `_eval_far_list` in the JAX
ops/bh.py); on a CUDA device it launches its kernel or raises. There is no
fallback from one to the other. `LAUNCHES` counts kernel launches per
wrapper. K1's wrapper runs in a `bh.near` span, and it (the card) or
`near_field_plain` (the CPU) counts the pair terms evaluated
("k1.pair_terms", live list entries x G^2; "k1.sym_terms", the mutual
entries x G^2 of the mutual form); K2's and K4's run in a
`bh.far` span and, while tracing is on, count their node x target terms
("far.terms", on the device); K1's item sizes reach the host through
`host_read`
(kernels/launch.py, utils/profiling.py).
"""

from __future__ import annotations

import dataclasses

import torch

from parallelnbody_tpu_torch.kernels.launch import (COUNTERS, check,
                                                    count_on_device, host_read,
                                                    launch, on_cpu, ptr)
from parallelnbody_tpu_torch.utils.profiling import is_tracing, span

LAUNCHES = {"near_field": 0, "near_field_window": 0, "near_field_table": 0,
            "far_octet": 0, "far_gather": 0}
# Launches of the mutual form's pairing (csrc/near_pairs.cu), two C calls
# a list build.
PAIR_LAUNCHES = {"near_pairs": 0}

# K1 work-item length: a near-list row is cut into items of at most this
# many source leaves, one block each (csrc/near_field.cu; chosen on the card,
# PERF.md §6).
NEAR_CHUNK = 32
# The largest leaf at which K1 evaluates mutual leaf pairs once
# (`near_pairs`): a block is then one warp of ceil(G / R) <= 32 threads,
# R <= 8 targets each, whose lanes rotate over the source tile's sums.
PAIR_LEAF_MAX = 256
# The window form sizes each window's items and blocks by the window's own
# work (`window_shape`): (targets a thread R, entries an item C) in the
# order tried. A heavy window keeps the unwindowed form's one-warp blocks;
# a lighter one, whose launch would otherwise last as long as one warp's
# serial sweep of its longest item, takes shorter items and then more
# warps an item over the same G targets.
WINDOW_SHAPES = ((8, 32), (8, 16), (8, 8), (4, 8), (2, 8), (1, 8), (1, 4),
                 (1, 2), (1, 1))
# A shape is taken when the window's pair terms, spread over every warp
# scheduler of the card, are at least this many times the longest item's
# serial sweep (pair terms a lane). Chosen on the card from one launch of
# each shape on each ring window of rank 0 of the 4M LET example
# (tools/k1_windows.py, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md): the own
# window (130093 entries) ran 8x8 4.18 ms, 8x16 4.20, 8x32 4.37, 4x8 4.26;
# the three neighbours' (9272-10681 entries) 1x4 0.37-0.42 ms against 4x8
# 0.44-0.56 and 8x8 0.51; the four smallest (112-1669 entries) 0.11-0.20 ms
# at any R = 1 shape. 24 picks 8x8 for the first and 1x4 for the
# neighbours; every value from 16 to 30 picks within 2% of the best.
WINDOW_TAIL = 24
_SCHEDULERS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class NearWork:
    """K1's work items for one set of near lists (`near_items`); unpacks
    and indexes as the triple (items, splits, n_partial)."""

    items: torch.Tensor   # (n_items, 4) int32 [row, begin, end, dst]
    splits: torch.Tensor  # (n_split, 3) int32 [row, first, n]
    n_partial: int
    # Targets a thread (8, 4, 2, 1; 0 = the most that leave a block a full
    # warp at the leaf size) and entries an item.
    r: int = 0
    chunk: int = NEAR_CHUNK
    # Every row has an item (an empty row one empty item, which writes its
    # zeros): the items of a launch that writes its output. False: rows
    # with no entry have none, for a launch that adds into its output.
    every_row: bool = True
    # List entries the items cover (K1's pair terms are entries x G^2).
    entries: int = 0
    # The list build's clip counter, read with the item sizes
    # (near_work(overflow=)); None where none was asked for.
    overflow: int | None = None
    # The mutual form (`near_pairs`), None elsewhere: the source leaves of
    # the served entries in one flat list (each row's one-way run, then
    # its mutual run; `items` and `pairs` index it), the partial slot that
    # takes each mutual entry's source-side sums (`slot_of`, beside
    # `srcs`), and the mutual items (n_pairs, 4) int32 [row, begin, end,
    # dst], longest first.
    srcs: torch.Tensor | None = None
    slot_of: torch.Tensor | None = None
    pairs: torch.Tensor | None = None
    # Mutual entries: unordered leaf pairs evaluated once for both leaves.
    sym_entries: int = 0

    def __iter__(self):
        return iter((self.items, self.splits, self.n_partial))

    def __getitem__(self, i):
        return (self.items, self.splits, self.n_partial)[i]


def reset_launch_counts():
    for counts in (LAUNCHES, PAIR_LAUNCHES):
        for name in counts:
            counts[name] = 0


# Element budget of one plain-version temporary plane (list entries x G
# targets x sources): bounds the plain versions' memory at the main path's
# shapes (~0.4 GB per (.., 3) temporary).
_PLAIN_BLOCK_ELEMS = 1 << 25


# ------------------------------------------------------------ plain versions
def _octet_terms(keys, valid):
    """() int64: the accepted children of the valid octet keys, the set
    bits of their child masks (keys & 0xFF), counted on the keys' device."""
    m = torch.where(valid, keys & 0xFF, 0)
    m = m - ((m >> 1) & 0x55)
    m = (m & 0x33) + ((m >> 2) & 0x33)
    return ((m + (m >> 4)) & 0x0F).sum(dtype=torch.int64)


def near_field_plain(pos_s, mass_s, tgt_leaves, idx, valid, *, g, softening,
                     compute_pot=True, leaf_lo=None, src_table=None,
                     out=None):
    """Exact softened near field (plain torch): targets (L, G, 3) against
    per-target lists of source leaves idx/valid (L, B) over the sorted
    particles pos_s (n_pad, 3), mass_s (n_pad,). Returns
    (acc (L*G, 3), pot (L*G,)).

    leaf_lo: pos_s/mass_s hold the shard of leaves [leaf_lo, leaf_lo +
    n_pad / G); entries outside it are skipped (the window arithmetic of
    the JAX package's ring near field). src_table: the sources are this
    packed (n_rows * G, 4) [x, y, z, m] table (pos_s and mass_s are None);
    entries naming a row past it are skipped (its LET clip). out = (acc,
    pot): add the result into them in place and return them, rows with no
    entry untouched, pot untouched without the potential (the kernel's
    out=).

    The pair terms are those of `_near_field_jnp`. Only the live (target
    leaf, source leaf) entries are evaluated, in chunks of entries taken
    row by row in list order, so a row's terms add up in the same order as
    the JAX scan over list columns; a chunk's sums go to their target rows
    with index_add_."""
    n_slice, leaf_size, _ = tgt_leaves.shape
    if src_table is not None:
        pos_s, mass_s = src_table[:, :3], src_table[:, 3]
    n_leaves = pos_s.shape[0] // leaf_size
    eps2 = float(softening) ** 2
    guard_zero = softening == 0.0
    p = pos_s.reshape(n_leaves, leaf_size, 3)
    m = mass_s.reshape(n_leaves, leaf_size)
    acc = tgt_leaves.new_zeros((n_slice, leaf_size, 3))
    pot = tgt_leaves.new_zeros((n_slice, leaf_size))
    off = int(leaf_lo or 0)
    if leaf_lo is not None or src_table is not None:
        valid = valid & (idx >= off) & (idx < off + n_leaves)
    rows, cols = torch.nonzero(valid, as_tuple=True)
    COUNTERS["k1.pair_terms"] += rows.shape[0] * leaf_size ** 2
    srcs = idx[rows, cols].long() - off
    chunk = max(1, _PLAIN_BLOCK_ELEMS // (leaf_size * leaf_size))
    for c0 in range(0, rows.shape[0], chunk):
        r = rows[c0:c0 + chunk]
        s = srcs[c0:c0 + chunk]
        d = p[s][:, None, :, :] - tgt_leaves[r][:, :, None, :]  # (P, G, G, 3)
        r2 = torch.sum(d * d, dim=-1) + eps2
        u = torch.rsqrt(r2)
        if guard_zero:
            u = torch.where(r2 > 0, u, torch.zeros_like(u))
        mu = m[s][:, None, :] * u
        w = mu * u * u
        acc.index_add_(0, r, torch.einsum("pij,pijc->pic", w, d))
        if compute_pot:
            pot.index_add_(0, r, -torch.sum(mu, dim=-1))
    n_out = n_slice * leaf_size
    acc, pot = g * acc.reshape(n_out, 3), g * pot.reshape(n_out)
    if out is None:
        return acc, pot
    live = torch.zeros(n_slice, dtype=torch.bool, device=acc.device)
    live[rows] = True
    live = live.repeat_interleave(leaf_size)
    out[0][live] += acc[live]
    if compute_pot:
        out[1][live] += pot[live]
    return out


def _far_nodes_plain(tgt, npos, nm, nq, eps2, guard_zero, compute_pot):
    """Node multipoles against target leaves (the math of `_far0_jnp`):
    tgt (R, G, 3); npos (R, K, 3); nm (R, K) (invalid entries zero mass);
    nq optional (R, K, 5). Returns unscaled (acc (R, G, 3), pot (R, G))."""
    d = npos[:, None, :, :] - tgt[:, :, None, :]          # (R, G, K, 3)
    r2 = torch.sum(d * d, dim=-1) + eps2
    u = torch.rsqrt(r2)
    if guard_zero:
        u = torch.where(r2 > 0, u, torch.zeros_like(u))
    mu = nm[:, None, :] * u
    w = mu * u * u
    acc = torch.einsum("bgk,bgkc->bgc", w, d)
    pot = -torch.sum(mu, dim=-1)
    if nq is not None:
        q = nq[:, None]                                   # (R, 1, K, 5)
        qzz = -(q[..., 0] + q[..., 1])
        qd = torch.stack([
            q[..., 0] * d[..., 0] + q[..., 2] * d[..., 1] + q[..., 3] * d[..., 2],
            q[..., 2] * d[..., 0] + q[..., 1] * d[..., 1] + q[..., 4] * d[..., 2],
            q[..., 3] * d[..., 0] + q[..., 4] * d[..., 1] + qzz * d[..., 2],
        ], dim=-1)
        qq = torch.sum(qd * d, dim=-1)                    # (R, G, K)
        u2 = u * u
        u5 = u2 * u2 * u
        c1 = 2.5 * qq * u5 * u2
        acc = acc + torch.einsum("bgk,bgkc->bgc", c1, d) \
                  - torch.einsum("bgk,bgkc->bgc", u5, qd)
        pot = pot - torch.sum(0.5 * qq * u5, dim=-1)
    if not compute_pot:
        pot = torch.zeros_like(pot)
    return acc, pot


def far_octet_plain(tgt_leaves, nodes8, keys, valid, *, g, softening,
                    compute_pot=True):
    """Octet-masked multipole far field (plain torch): targets (L, G, 3)
    against per-target lists of (octet_id << 8) | child_mask keys over the
    8-row-aligned node table nodes8 (n8, 4|9). Each key's (8, C) sibling
    tile is expanded with its child mask and evaluated with the node-list
    math (`_far_octet_jnp`). Returns (acc (L*G, 3), pot (L*G,))."""
    n_slice, leaf_size, _ = tgt_leaves.shape
    n_comp = nodes8.shape[1]
    with_quad = n_comp >= 9
    eps2 = float(softening) ** 2
    guard_zero = softening == 0.0
    tiles8 = nodes8.reshape(-1, 8, n_comp)
    bit = torch.arange(8, dtype=torch.int32, device=keys.device)
    acc = tgt_leaves.new_zeros((n_slice, leaf_size, 3))
    pot = tgt_leaves.new_zeros((n_slice, leaf_size))
    counts = torch.sum(valid, dim=1)
    chunk = max(1, min(64, keys.shape[1]))
    rows = max(1, _PLAIN_BLOCK_ELEMS // (leaf_size * chunk * 8))
    for r0 in range(0, n_slice, rows):
        r1 = min(n_slice, r0 + rows)
        n_live = int(torch.max(counts[r0:r1], dim=0).values) if r1 > r0 else 0
        for c0 in range(0, n_live, chunk):
            kk = keys[r0:r1, c0:c0 + chunk]
            vv = valid[r0:r1, c0:c0 + chunk]
            t = tiles8[torch.where(vv, kk >> 8, 0).long()]  # (R, C8, 8, nc)
            mask = (((kk[..., None] >> bit) & 1) > 0) & vv[..., None]
            npos = t[..., :3].reshape(r1 - r0, -1, 3)
            nm = torch.where(mask, t[..., 3], 0.0).reshape(r1 - r0, -1)
            nq = (torch.where(mask[..., None], t[..., 4:9], 0.0)
                  .reshape(r1 - r0, -1, 5) if with_quad else None)
            a, ph = _far_nodes_plain(tgt_leaves[r0:r1], npos, nm, nq, eps2,
                                     guard_zero, compute_pot)
            acc[r0:r1] += a
            pot[r0:r1] += ph
    n_out = n_slice * leaf_size
    return g * acc.reshape(n_out, 3), g * pot.reshape(n_out)


def far_gather_plain(tgt_leaves, table, idx, valid, *, g, softening,
                     compute_pot=True):
    """Multipole far field over per-target lists of node rows (plain
    torch): targets (L, G, 3) against idx (L, B) int32 rows of table
    (n_nodes, 4|9) with the node-list math (`_far_nodes_plain`). Entries
    whose valid (L, B) bit is False contribute nothing, so front-packed and
    scattered lists both work (the jnp branch of the JAX package's
    `_eval_far_list`). Row blocks walk columns up to their last valid entry.
    Returns (acc (L*G, 3), pot (L*G,))."""
    n_slice, leaf_size, _ = tgt_leaves.shape
    with_quad = table.shape[1] >= 9
    eps2 = float(softening) ** 2
    guard_zero = softening == 0.0
    acc = tgt_leaves.new_zeros((n_slice, leaf_size, 3))
    pot = tgt_leaves.new_zeros((n_slice, leaf_size))
    chunk = max(1, min(512, idx.shape[1]))
    rows = max(1, _PLAIN_BLOCK_ELEMS // (leaf_size * chunk))
    for r0 in range(0, n_slice, rows):
        r1 = min(n_slice, r0 + rows)
        live_cols = torch.nonzero(torch.any(valid[r0:r1], dim=0))
        n_cols = int(live_cols[-1]) + 1 if live_cols.numel() else 0
        for c0 in range(0, n_cols, chunk):
            vv = valid[r0:r1, c0:c0 + chunk]
            t = table[torch.where(vv, idx[r0:r1, c0:c0 + chunk], 0).long()]
            nm = torch.where(vv, t[..., 3], 0.0)
            nq = (torch.where(vv[..., None], t[..., 4:9], 0.0)
                  if with_quad else None)
            a, ph = _far_nodes_plain(tgt_leaves[r0:r1], t[..., :3], nm, nq,
                                     eps2, guard_zero, compute_pot)
            acc[r0:r1] += a
            pot[r0:r1] += ph
    n_out = n_slice * leaf_size
    return g * acc.reshape(n_out, 3), g * pot.reshape(n_out)


# ------------------------------------------------------------------ wrappers
def far_rows(table):
    """The node rows that K2 and K4 stage with 16-byte copies, from a
    multipole table (n, 9) [x, y, z, m, Qxx, Qyy, Qxy, Qxz, Qyz]: (n, 12)
    [x, y, z, m, Qxx, Qyy, Qxy, Qxz, Qyz, Qzz, 0, 0], Qzz = -(Qxx + Qyy)
    formed once per node (csrc/terms.cuh quad_term). A monopole table
    (n, 4) is its own packing, returned as it is, or copied where its rows
    do not start on a 16-byte boundary. Three small torch ops on every call
    of the wrappers; the plain versions read the (n, 9) table."""
    if table.shape[1] == 4:
        return table if table.data_ptr() % 16 == 0 else table.clone()
    rows = torch.nn.functional.pad(table, (0, 3))
    torch.add(table[:, 4], table[:, 5], out=rows[:, 9]).neg_()
    return rows


def heaviest_first(counts):
    """The order in which K2 and K4 run their target leaves, one block
    each: by live list length (L,), longest first, as int32. The card
    starts blocks in this order, so the longest lists no longer finish
    last (csrc/far_octet.cu); any order gives the same bits, since a
    leaf's sums never leave its block. A stable sort on the lists'
    device."""
    return torch.argsort(counts, descending=True, stable=True).to(
        torch.int32)


def far_order(valid):
    """K2's or K4's launch order (`heaviest_first`) for the front-packed
    far lists whose mask is valid (L, B). Built once per list build, next
    to the list builder, so that lists evaluated several times (the
    rebuild-interval runs) sort once, not once a step. None for CPU lists:
    the plain versions need no order."""
    if valid.device.type == "cpu":
        return None
    return heaviest_first(torch.sum(valid, dim=1, dtype=torch.int32))


def _window_sizes(counts, chunks, extra=()):
    """Per column of counts (L, P) int64, one (P, 3 + 3 len(chunks)) tensor
    on its device: entries, the longest row and the rows with none; then
    for each chunk, near_items(..., every_row=False)'s items, partial slots
    and split rows; then the (P,) int64 columns `extra`, in the same
    stack."""
    cols = [counts.sum(0), counts.max(0).values, (counts == 0).sum(0)]
    for chunk in chunks:
        n = (counts + chunk - 1) // chunk
        split = n > 1
        cols += [n.sum(0), torch.where(split, n, 0).sum(0), split.sum(0)]
    return torch.stack(cols + list(extra), 1)


def _sizes_of(row, k, every_row):
    """(n_items, n_partial, n_split, entries) of near_items for the k-th
    chunk of a _window_sizes row read back to the host."""
    n_items, n_partial, n_split = row[3 + 3 * k:6 + 3 * k]
    return n_items + (row[2] if every_row else 0), n_partial, n_split, row[0]


def _cut(counts, n_chunks, chunk, n_items, lo, dst0):
    """The items (n_items, 4) int64 [row, begin, end, dst] that cut each
    row's run of counts (L,) entries into n_chunks (L,) items of at most
    `chunk`, longest first (a stable sort, so a row's items keep their
    order among equals). begin / end count from lo (L,) (None: 0); an
    item's dst is dst0[row] + its chunk number where dst0[row] >= 0, else
    -1 (the row's single item, which stores the row)."""
    dev = counts.device
    first_item = torch.cumsum(n_chunks, 0) - n_chunks
    rows = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                   n_chunks, output_size=n_items)
    k = torch.arange(n_items, device=dev) - first_item[rows]
    begin = k * chunk
    end = torch.minimum(begin + chunk, counts[rows])
    dst = torch.where(dst0[rows] >= 0, dst0[rows] + k, -1)
    order = torch.sort(end - begin, descending=True, stable=True).indices
    if lo is not None:
        start = lo.to(torch.int64)[rows]
        begin, end = begin + start, end + start
    return torch.stack([rows, begin, end, dst], dim=1)[order]


def _rows_where(mask, n):
    """The n rows where mask (L,) is True, ascending, without a sync of
    their own."""
    return torch.sort((~mask).to(torch.int8), stable=True).indices[:n]


def near_items(counts, chunk, lo=None, sizes=None, r=0, every_row=True,
               overflow=None):
    """K1's work items from the live length counts (L,) of front-packed
    near lists: every row is cut into ceil(count / chunk) items of at most
    `chunk` entries (with every_row an empty row into one empty item, which
    writes its zeros; without it an empty row has no item). Returns a
    NearWork (items (n_items, 4) int32 [row, begin, end, dst], splits
    (n_split, 3) int32 [row, first, n], n_partial), items longest first (a
    stable sort, so a row's items keep their order among equals). dst is -1
    for the single item of a row, which writes (or adds) the row's output;
    the n items of a split row write partial slots first .. first + n - 1
    in chunk order, which `splits` names for the combining pass; n_partial
    slots in all. r: the targets a thread the launch uses (NearWork.r).

    lo (L,): the list position where each row's run starts (the window and
    table forms: a row evaluates positions [lo, lo + count)); None = 0.
    begin and end are list positions.

    Index bookkeeping in a few torch ops on the lists' device; reading the
    sizes back waits on the host once (`host_read`; sizes: `_sizes_of`,
    read back by the caller). overflow: a 0-d int64 tensor (a list build's
    clip counter) read in the same read, into NearWork.overflow; only
    where the sizes are read here."""
    counts = counts.to(torch.int64)
    n_chunks = (counts + chunk - 1) // chunk
    if every_row:
        n_chunks = torch.clamp(n_chunks, min=1)
    split = n_chunks > 1
    split_n = torch.where(split, n_chunks, 0)
    if sizes is None:
        extra = () if overflow is None else (overflow.reshape(1),)
        row = host_read(_window_sizes(counts[:, None], (chunk,), extra)[0])
        sizes = _sizes_of(row, 0, every_row)
        if overflow is not None:
            overflow = row[-1]
    n_items, n_partial, n_split, entries = sizes
    first_slot = torch.cumsum(split_n, 0) - split_n
    items = _cut(counts, n_chunks, chunk, n_items, lo,
                 torch.where(split, first_slot, -1))
    split_rows = _rows_where(split, n_split)
    splits = torch.stack([split_rows, first_slot[split_rows],
                          n_chunks[split_rows]], dim=1)
    return NearWork(items.to(torch.int32).contiguous(),
                    splits.to(torch.int32).contiguous(), n_partial, r=r,
                    chunk=chunk, every_row=every_row, entries=entries,
                    overflow=overflow)


def pair_targets(leaf_size):
    """Targets a thread of K1's mutual form at this leaf size: the fewest
    of 1, 2, 4, 8 that fit the leaf in one warp (csrc/near_field.cu); 0
    above PAIR_LEAF_MAX, where the form does not run."""
    for r in (1, 2, 4, 8):
        if leaf_size <= 32 * r:
            return r
    return 0


def near_pairs(idx, valid, chunk=NEAR_CHUNK, overflow=None):
    """K1's work items in the mutual form, for front-packed ascending near
    lists idx/valid (L, B) over all L leaves whose rows are those leaves
    themselves (targets = sources). A live entry (t, s) is mutual where
    t != s and t is in s's list too: the copy with t < s is kept as a
    mutual entry of row t, which K1 evaluates once for both leaves
    (Newton's third law), and the mirror (s, t) is dropped from s's work.
    Every other entry, the self entry (t, t) among them, is one-way.

    Each row's one-way entries, then its mutual ones, go into one flat
    list (NearWork.srcs), both in list order, and are cut as near_items
    cuts a row: one-way items of at most `chunk` entries (an empty run
    one empty item, which writes its zeros), mutual items likewise (none
    for an empty run), each kind longest first. A row whose one item is
    all its work (one-way, nothing incoming) stores its output; every
    other row gets a run of partial slots that the combining pass adds in
    order: its one-way items', its mutual items' (chunk order), then the
    source-side sums of the mutual entries that name it, one slot each,
    in ascending partner order (NearWork.slot_of: the slot of each kept
    entry).

    On CUDA tensors the pairing runs in csrc/near_pairs.cu (two C calls,
    three launches, then one stable sort of the items by length); the
    sizes (with `overflow`, as near_items reads it) reach the host in one
    `host_read` between them. Elsewhere it runs in torch ops, which the
    card tests hold the kernels to item for item: the mirrors are found by
    one search of the row-major keys t (L + 1) + s, ascending because the
    lists are, for s (L + 1) + t, and after the one `host_read` the
    entries are compacted at the sizes read (nonzero_static: no wait of
    its own)."""
    if valid.device.type == "cuda":
        return _near_pairs_cuda(idx, valid, chunk, overflow)
    n_rows, budget = valid.shape
    dev = valid.device
    n_all = n_rows * budget
    t = torch.arange(n_rows, device=dev)[:, None]
    s = idx.to(torch.int64)
    keys = (t * (n_rows + 1) + torch.where(valid, s, n_rows)).reshape(-1)
    want = (s * (n_rows + 1) + t).reshape(-1)
    at = torch.searchsorted(keys, want, out_int32=True).clamp_(max=n_all - 1)
    # A dead entry's key names no leaf, so only live entries are hit.
    hit = (keys[at] == want).reshape(n_rows, budget) & valid
    del keys, want
    keep, drop = hit & (s > t), hit & (s < t)
    del s, hit
    one = valid & ~(keep | drop)
    n_keep, n_in = keep.sum(1), drop.sum(1)
    counts = valid.sum(1)
    n_one = counts - n_keep - n_in
    one_items = torch.clamp((n_one + chunk - 1) // chunk, min=1)
    keep_items = (n_keep + chunk - 1) // chunk
    own = one_items + keep_items
    block = torch.where(own + n_in > 1, own + n_in, 0)
    first = torch.cumsum(block, 0) - block
    served = n_one + n_keep
    base = torch.cumsum(served, 0) - served
    extra = [] if overflow is None else [overflow.reshape(())]
    sizes = host_read(torch.stack([
        counts.sum(), one_items.sum(), keep_items.sum(), block.sum(),
        (block > 0).sum(), served.sum(), n_keep.sum(), *extra]))
    entries, n_items, n_pairs, n_partial, n_split, n_served, n_sym = sizes[:7]
    # The served entries in list order (each row's one-way entries, then
    # its kept ones), compacted at the size just read: no wait of its own.
    pos = torch.nonzero_static(torch.stack([one, keep], dim=1).reshape(-1),
                               size=n_served).reshape(-1)
    grid = pos // (2 * budget) * budget + pos % budget
    srcs = idx.reshape(-1)[grid].contiguous()
    # The dropped entries in list order are the incoming slots, each row's
    # in ascending partner order; a kept entry's slot is its mirror's (-1
    # beside a one-way entry).
    dropped = torch.nonzero_static(drop.reshape(-1), size=n_sym).reshape(-1)
    rows_in = dropped // budget
    in_base = torch.cumsum(n_in, 0) - n_in
    slot_at = torch.empty(n_all, dtype=torch.int32, device=dev)
    slot_at[dropped] = ((first + own - in_base)[rows_in] + torch.arange(
        n_sym, device=dev)).to(torch.int32)
    slot_of = torch.where(pos // budget % 2 == 1, slot_at[at[grid]],
                          -1).to(torch.int32)
    combined = block > 0
    items = _cut(n_one, one_items, chunk, n_items, base,
                 torch.where(combined, first, -1))
    pairs = _cut(n_keep, keep_items, chunk, n_pairs, base + n_one,
                 first + one_items)
    split_rows = _rows_where(combined, n_split)
    splits = torch.stack([split_rows, first[split_rows], block[split_rows]],
                         dim=1)
    return NearWork(items.to(torch.int32).contiguous(),
                    splits.to(torch.int32).contiguous(), n_partial,
                    r=0, chunk=chunk, entries=entries,
                    overflow=sizes[7] if overflow is not None else None,
                    srcs=srcs, slot_of=slot_of,
                    pairs=pairs.to(torch.int32).contiguous(),
                    sym_entries=n_sym)


def _near_pairs_cuda(idx, valid, chunk, overflow):
    """near_pairs on the card (csrc/near_pairs.cu): the entries' kinds and
    the rows' offsets, one read of the sizes, then the served sources,
    slots, items and splits, and the items' stable sort by length (one-way
    items first, each kind longest first)."""
    n_rows, budget = valid.shape
    dev = valid.device
    check("idx", idx, torch.int32, (n_rows, budget))
    check("valid", valid, torch.bool, (n_rows, budget))
    kind = torch.empty((n_rows, budget), dtype=torch.int8, device=dev)
    aux = torch.empty((n_rows, budget), dtype=torch.int32, device=dev)
    rowc = torch.empty((n_rows, 4), dtype=torch.int32, device=dev)
    offs = torch.empty((n_rows, 8), dtype=torch.int32, device=dev)
    sizes = torch.empty(8, dtype=torch.int64, device=dev)
    if overflow is not None:
        overflow = overflow.reshape(()).to(torch.int64)
    launch(PAIR_LAUNCHES, "near_pairs", "pnb_near_pairs_count", ptr(idx),
           ptr(valid), ptr(kind), ptr(aux), ptr(rowc), ptr(offs),
           ptr(sizes), None if overflow is None else ptr(overflow), n_rows,
           budget, chunk)
    (entries, n_items, n_pairs, n_partial, n_split, n_served, n_sym,
     clipped) = host_read(sizes)
    i32 = dict(dtype=torch.int32, device=dev)
    srcs = torch.empty(n_served, **i32)
    slot_of = torch.empty(n_served, **i32)
    both = torch.empty((n_items + n_pairs, 4), **i32)
    keys = torch.empty(n_items + n_pairs, **i32)
    splits = torch.empty((n_split, 3), **i32)
    launch(PAIR_LAUNCHES, "near_pairs", "pnb_near_pairs_emit", ptr(idx),
           ptr(kind), ptr(aux), ptr(rowc), ptr(offs), ptr(srcs),
           ptr(slot_of), ptr(both), ptr(keys), ptr(splits), n_rows, budget,
           chunk, n_items)
    both = both[torch.sort(keys, stable=True).indices]
    return NearWork(both[:n_items], splits, n_partial, r=0, chunk=chunk,
                    entries=entries,
                    overflow=clipped if overflow is not None else None,
                    srcs=srcs, slot_of=slot_of, pairs=both[n_items:],
                    sym_entries=n_sym)


def near_work(valid, idx=None, id_range=None, overflow=None, sources=None):
    """K1's work items (`near_items`, NEAR_CHUNK entries at most) for the
    front-packed near lists whose mask is valid (L, B), where a row's valid
    count is its live length. id_range = (id_lo, id_hi) keeps each row's
    run of entries with ids idx (L, B) in [id_lo, id_hi): the window form
    (a shard's leaves) and the table form ([0, n_rows)). Built once per
    list build, next to the list builder, so that lists evaluated several
    times (the rebuild-interval runs) wait on the host once, not once a
    step. None for CPU lists: `near_field_plain` needs no items.

    sources = (n_leaves, leaf_size) of the sorted particles whose leaves
    idx names: where the lists' rows are those leaves themselves (L ==
    n_leaves, no id_range; the targets are the sources) and the leaf size
    is at most PAIR_LEAF_MAX, the items are `near_pairs`', which evaluate
    each mutual leaf pair once. Other lists (a target window's rows, the
    window and table forms), or no idx, get the one-way items.

    overflow: the list build's 0-d int64 clip counter, read with the item
    sizes into NearWork.overflow (no read of its own); unwindowed lists
    only."""
    if valid.device.type == "cpu":
        return None
    if id_range is None:
        if idx is not None and sources is not None and \
                valid.shape[0] == sources[0] and pair_targets(sources[1]):
            return near_pairs(idx, valid, NEAR_CHUNK, overflow=overflow)
        return near_items(torch.sum(valid, dim=1), NEAR_CHUNK,
                          overflow=overflow)
    return near_windows(idx, valid, id_range, chunk=NEAR_CHUNK)[0]


def _full_warp_r(leaf_size):
    """The most targets a thread that still leave a block a full warp
    (csrc/near_field.cu, r = 0)."""
    for r in (8, 4, 2):
        if leaf_size >= 32 * r:
            return r
    return 1


def window_shape(entries, longest, leaf_size, n_sm):
    """(targets a thread, entries an item) for K1's launch over one window
    of `entries` list entries whose longest row holds `longest`: the first
    of WINDOW_SHAPES (R capped by the leaf size's full-warp R) whose longest
    item, swept serially by one warp (min(C, longest) * G * R pair terms a
    lane), takes at most 1 / WINDOW_TAIL of the window's pair terms spread
    over the card's warp schedulers; the last shape when none does."""
    r_top = _full_warp_r(leaf_size)
    per_lane = entries * leaf_size * leaf_size / (
        32 * _SCHEDULERS_PER_SM * n_sm)
    for r, chunk in WINDOW_SHAPES:
        r = min(r, r_top)
        if min(chunk, longest) * leaf_size * r * WINDOW_TAIL <= per_lane:
            return r, chunk
    return WINDOW_SHAPES[-1]


def near_windows(idx, valid, edges, chunk=None, writes=None, leaf_size=None,
                 n_sm=None):
    """K1's work items for each window [edges[w], edges[w + 1]) of leaf
    ids over the front-packed ascending lists idx/valid (L, B): ascending
    lists make each window a run [lo, hi) of list positions, counted here
    for every window at once. One host wait for all windows. Returns a list
    of len(edges) - 1 NearWork, on the lists' device.

    chunk: items of at most this many entries at the leaf size's full-warp
    R in every window. None: each window's own shape (`window_shape`, from
    its entries and longest row; leaf_size and n_sm, the SM count of the
    lists' device when None, enter it). writes: the windows whose items
    cover every row, for a launch that writes its output; the others skip
    the rows with no entry in them, for a launch that adds into its output
    (near_field's out=). None: every window."""
    bounds = torch.stack([torch.sum(valid & (idx < e), dim=1)
                          for e in edges], dim=1)
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int64)
    n_win = counts.shape[1]
    shaped = chunk is None
    chunks = tuple(sorted({c for _, c in WINDOW_SHAPES}, reverse=True)) \
        if shaped else (chunk,)
    table = host_read(_window_sizes(counts, chunks))
    if shaped:
        if leaf_size is None:
            raise ValueError("near_windows: a window's own shape needs "
                             "leaf_size")
        if n_sm is None:
            n_sm = torch.cuda.get_device_properties(
                idx.device).multi_processor_count
    out = []
    for w in range(n_win):
        row = table[w]
        r, c = (window_shape(row[0], row[1], leaf_size, n_sm) if shaped
                else (0, chunk))
        every_row = writes is None or w in writes
        out.append(near_items(counts[:, w], c, lo=bounds[:, w],
                              sizes=_sizes_of(row, chunks.index(c),
                                              every_row),
                              r=r, every_row=every_row))
    return out


def near_field(pos_s, mass_s, tgt_leaves, idx, valid, *, g, softening,
               compute_pot=True, work=None, leaf_lo=None, src_table=None,
               out=None):
    """K1: exact near field of targets (L, G, 3) against their front-packed
    ascending lists of source leaves idx (L, B) int32 / valid (L, B) bool
    over the sorted particles pos_s (n_pad, 3), mass_s (n_pad,). Returns
    (acc (L*G, 3), pot (L*G,)). CPU tensors run `near_field_plain`; CUDA
    tensors launch the kernel (f32 only) on the work items `work` (built
    here by `near_work` when None) and a packed (n_pad, 4) [x, y, z, m]
    source table.

    Window form, leaf_lo (an int): pos_s/mass_s are the shard of sorted
    particles holding leaves [leaf_lo, leaf_lo + n_pad / G); idx keeps
    global leaf ids and only the entries inside the window are evaluated
    (items built here by `near_windows` with the window's own shape).
    Table form, src_table: the sources are this packed (n_rows * G, 4)
    table (pos_s and mass_s are None); entries with idx >= n_rows are
    skipped. Each form counts its launches under its own name.

    out = (acc, pot): add this call's sums into them in place (each term
    rounded as if written and then added) and return them; rows with no
    entry are not touched, and pot not at all without the potential. The
    ring near field accumulates its passes so.

    Mutual form: where the lists cover every leaf (n_slice * G == n_pad,
    neither leaf_lo nor src_table) and the targets are the sources
    (tgt_leaves is pos_s's own memory), work built here pairs each mutual
    leaf pair (`near_pairs`, through `near_work(sources=)`) and one launch
    evaluates it once for both leaves; prebuilt work of that form is taken
    only there, without out=. It counts "k1.sym_terms" (mutual entries x
    G^2) beside "k1.pair_terms"."""
    with span("bh.near"):
        if src_table is not None:
            if pos_s is not None or mass_s is not None or \
                    leaf_lo is not None:
                raise ValueError("src_table replaces pos_s, mass_s and "
                                 "leaf_lo")
            srcs, form = (src_table,), "near_field_table"
        else:
            srcs = (pos_s, mass_s)
            form = "near_field" if leaf_lo is None else "near_field_window"
        outs = () if out is None else tuple(out)
        n_slice, leaf_size, _ = tgt_leaves.shape
        n_pad = srcs[0].shape[0]
        if on_cpu(*srcs, tgt_leaves, idx, valid, *outs):
            return near_field_plain(pos_s, mass_s, tgt_leaves, idx, valid,
                                    g=g, softening=softening,
                                    compute_pot=compute_pot, leaf_lo=leaf_lo,
                                    src_table=src_table, out=out)
        budget = idx.shape[1]
        if n_pad % leaf_size or not 0 < leaf_size <= 1024:
            raise ValueError(f"leaf size {leaf_size} must divide {n_pad} and "
                             "be at most 1024")
        if src_table is not None:
            check("src_table", src_table, torch.float32, (n_pad, 4))
            table = src_table
        else:
            check("pos_s", pos_s, torch.float32, (n_pad, 3))
            check("mass_s", mass_s, torch.float32, (n_pad,))
            table = torch.cat([pos_s, mass_s[:, None]], dim=1)
        check("tgt_leaves", tgt_leaves, torch.float32, (n_slice, leaf_size, 3))
        check("idx", idx, torch.int32, (n_slice, budget))
        check("valid", valid, torch.bool, (n_slice, budget))
        dev = table.device
        off = int(leaf_lo or 0)
        whole = (form == "near_field" and out is None and
                 n_slice * leaf_size == n_pad and
                 tgt_leaves.data_ptr() == pos_s.data_ptr())
        if work is None and form == "near_field_window":
            work = near_windows(idx, valid, [off, off + n_pad // leaf_size],
                                writes=() if out is not None else None,
                                leaf_size=leaf_size)[0]
        elif work is None:
            work = near_work(valid, idx, None if form == "near_field" else
                             (0, n_pad // leaf_size),
                             sources=(n_slice, leaf_size) if whole else None)
        if work.pairs is not None:
            if not whole:
                raise ValueError("mutual work items need whole-set lists "
                                 "whose targets are pos_s's own leaves, and "
                                 "no out=")
            return _near_pairs_launch(table, work, n_slice, leaf_size,
                                      g=g, softening=softening,
                                      compute_pot=compute_pot)
        items, splits, n_partial = work
        check("work.items", items, torch.int32, (items.shape[0], 4))
        check("work.splits", splits, torch.int32, (splits.shape[0], 3))
        if work.r not in (0, 1, 2, 4, 8):
            raise ValueError(f"work.r {work.r}: targets a thread are 0 (the "
                             "leaf size's), 1, 2, 4 or 8")
        partial = torch.empty((n_partial, leaf_size, 4), dtype=torch.float32,
                              device=dev)
        if out is None:
            if not work.every_row:
                raise ValueError("work items that skip empty rows only add "
                                 "into an output (out=)")
            acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                              device=dev)
            pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32,
                              device=dev)
        else:
            acc, pot = out
            check("out acc", acc, torch.float32, (n_slice * leaf_size, 3))
            check("out pot", pot, torch.float32, (n_slice * leaf_size,))
        launch(LAUNCHES, form, "pnb_near_field",
               ptr(table), ptr(tgt_leaves), ptr(idx), ptr(items), ptr(splits),
               ptr(acc), ptr(pot), ptr(partial), items.shape[0],
               splits.shape[0], leaf_size, budget, off, float(g),
               float(softening) ** 2, int(softening == 0.0),
               int(bool(compute_pot)), int(out is not None), work.r)
        COUNTERS["k1.pair_terms"] += work.entries * leaf_size ** 2
        return acc, pot


def _near_pairs_launch(table, work, n_slice, leaf_size, *, g, softening,
                       compute_pot):
    """K1's mutual form (`near_pairs` items) on the packed table: one
    launch of both kinds of items and the combining pass."""
    items, splits, n_partial = work
    for name, t, cols in (("work.items", items, 4), ("work.pairs",
                                                      work.pairs, 4),
                          ("work.splits", splits, 3)):
        check(name, t, torch.int32, (t.shape[0], cols))
    n_served = work.srcs.shape[0]
    check("work.srcs", work.srcs, torch.int32, (n_served,))
    check("work.slot_of", work.slot_of, torch.int32, (n_served,))
    dev = table.device
    partial = torch.empty((n_partial, leaf_size, 4), dtype=torch.float32,
                          device=dev)
    acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                      device=dev)
    pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32,
                      device=dev)
    launch(LAUNCHES, "near_field", "pnb_near_field_pairs",
           ptr(table), ptr(work.srcs), ptr(work.slot_of), ptr(work.pairs),
           ptr(items), ptr(splits), ptr(acc), ptr(pot), ptr(partial),
           work.pairs.shape[0], items.shape[0], splits.shape[0], leaf_size,
           float(g), float(softening) ** 2, int(softening == 0.0),
           int(bool(compute_pot)))
    COUNTERS["k1.pair_terms"] += work.entries * leaf_size ** 2
    COUNTERS["k1.sym_terms"] += work.sym_entries * leaf_size ** 2
    return acc, pot


def far_octet(tgt_leaves, nodes8, keys, valid, *, g, softening,
              compute_pot=True, order=None):
    """K2: octet-masked multipole far field of targets (L, G, 3) against
    their front-packed lists of (octet_id << 8) | child_mask keys (L, B)
    int32 / valid (L, B) bool over the 8-row-aligned node table nodes8
    (n8, 4|9). Returns (acc (L*G, 3), pot (L*G,)). CPU tensors run
    `far_octet_plain`; CUDA tensors launch the kernel (f32 only) on the
    table packed by `far_rows`, target leaves in the launch order `order`
    (`far_order(valid)`, built here when None)."""
    with span("bh.far"):
        if is_tracing():
            count_on_device("far.terms", _octet_terms(keys, valid) *
                            tgt_leaves.shape[1])
        if on_cpu(tgt_leaves, nodes8, keys, valid):
            return far_octet_plain(tgt_leaves, nodes8, keys, valid, g=g,
                                   softening=softening,
                                   compute_pot=compute_pot)
        n_slice, leaf_size, _ = tgt_leaves.shape
        n8, n_comp = nodes8.shape
        budget = keys.shape[1]
        if n8 % 8 or n_comp not in (4, 9):
            raise ValueError(f"nodes8 {tuple(nodes8.shape)}: rows must be a "
                             "multiple of 8 and columns 4 or 9")
        if not 0 < leaf_size <= 1024:
            raise ValueError(f"leaf size {leaf_size} above 1024")
        check("tgt_leaves", tgt_leaves, torch.float32, (n_slice, leaf_size, 3))
        check("nodes8", nodes8, torch.float32, (n8, n_comp))
        check("keys", keys, torch.int32, (n_slice, budget))
        check("valid", valid, torch.bool, (n_slice, budget))
        rows = far_rows(nodes8)
        counts = torch.sum(valid, dim=1, dtype=torch.int32)
        order = heaviest_first(counts) if order is None else order
        check("order", order, torch.int32, (n_slice,))
        if order.device != counts.device:
            raise ValueError(f"order on {order.device}, lists on "
                             f"{counts.device}")
        acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                          device=nodes8.device)
        pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32,
                          device=nodes8.device)
        launch(LAUNCHES, "far_octet", "pnb_far_octet",
               ptr(rows), ptr(tgt_leaves), ptr(keys), ptr(counts), ptr(order),
               ptr(acc), ptr(pot), n_slice, leaf_size, budget, rows.shape[1],
               float(g), float(softening) ** 2, int(softening == 0.0),
               int(bool(compute_pot)))
        return acc, pot


def far_gather(tgt_leaves, table, idx, valid, *, g, softening,
               compute_pot=True, front_packed=True, order=None):
    """K4: multipole far field of targets (L, G, 3) against their lists of
    node rows idx (L, B) int32 / valid (L, B) bool over table
    (n_nodes, 4|9). front_packed=True: each row's valid entries come first
    and the kernel walks only those; front_packed=False: `valid` is a
    scattered mask and every entry is read, the valid ones compacted as
    they are staged. Returns (acc (L*G, 3), pot (L*G,)). CPU tensors run
    `far_gather_plain`; CUDA tensors launch the kernel (f32 only) on the
    table packed by `far_rows`, target leaves in the launch order `order`
    (`heaviest_first` of the valid counts, built here when None)."""
    with span("bh.far"):
        if is_tracing():
            count_on_device("far.terms", valid.sum(dtype=torch.int64) *
                            tgt_leaves.shape[1])
        if on_cpu(tgt_leaves, table, idx, valid):
            return far_gather_plain(tgt_leaves, table, idx, valid, g=g,
                                    softening=softening,
                                    compute_pot=compute_pot)
        n_slice, leaf_size, _ = tgt_leaves.shape
        n_nodes, n_comp = table.shape
        budget = idx.shape[1]
        if n_comp not in (4, 9):
            raise ValueError(f"table {tuple(table.shape)}: columns must be 4 "
                             "or 9")
        if not 0 < leaf_size <= 1024:
            raise ValueError(f"leaf size {leaf_size} above 1024")
        check("tgt_leaves", tgt_leaves, torch.float32, (n_slice, leaf_size, 3))
        check("table", table, torch.float32, (n_nodes, n_comp))
        check("idx", idx, torch.int32, (n_slice, budget))
        check("valid", valid, torch.bool, (n_slice, budget))
        rows = far_rows(table)
        counts = torch.sum(valid, dim=1, dtype=torch.int32)
        order = heaviest_first(counts) if order is None else order
        check("order", order, torch.int32, (n_slice,))
        if order.device != counts.device:
            raise ValueError(f"order on {order.device}, lists on "
                             f"{counts.device}")
        acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                          device=table.device)
        pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32,
                          device=table.device)
        launch(LAUNCHES, "far_gather", "pnb_far_gather",
               ptr(rows), ptr(tgt_leaves), ptr(idx), ptr(valid), ptr(counts),
               ptr(order), ptr(acc), ptr(pot), n_slice, leaf_size, budget,
               rows.shape[1],
               float(g), float(softening) ** 2, int(softening == 0.0),
               int(bool(compute_pot)), int(not front_packed))
        return acc, pot
