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
wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from parallelnbody_tpu_torch.kernels.launch import check, launch, on_cpu, ptr

LAUNCHES = {"near_field": 0, "far_octet": 0, "far_gather": 0}

# K1 work-item length: a near-list row is cut into items of at most this
# many source leaves, one block each (csrc/near_field.cu; chosen on the card,
# PERF.md §6).
NEAR_CHUNK = 32


class NearWork(NamedTuple):
    """K1's work items for one set of near lists (`near_items`)."""

    items: torch.Tensor   # (n_items, 4) int32 [row, begin, end, dst]
    splits: torch.Tensor  # (n_split, 3) int32 [row, first, n]
    n_partial: int


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Element budget of one plain-version temporary plane (list entries x G
# targets x sources): bounds the plain versions' memory at the main path's
# shapes (~0.4 GB per (.., 3) temporary).
_PLAIN_BLOCK_ELEMS = 1 << 25


# ------------------------------------------------------------ plain versions
def near_field_plain(pos_s, mass_s, tgt_leaves, idx, valid, *, g, softening,
                     compute_pot=True):
    """Exact softened near field (plain torch): targets (L, G, 3) against
    per-target lists of source leaves idx/valid (L, B) over the sorted
    particles pos_s (n_pad, 3), mass_s (n_pad,). Returns
    (acc (L*G, 3), pot (L*G,)).

    The pair terms are those of `_near_field_jnp`. Only the live (target
    leaf, source leaf) entries are evaluated, in chunks of entries taken
    row by row in list order, so a row's terms add up in the same order as
    the JAX scan over list columns; a chunk's sums go to their target rows
    with index_add_."""
    n_slice, leaf_size, _ = tgt_leaves.shape
    n_leaves = pos_s.shape[0] // leaf_size
    eps2 = float(softening) ** 2
    guard_zero = softening == 0.0
    p = pos_s.reshape(n_leaves, leaf_size, 3)
    m = mass_s.reshape(n_leaves, leaf_size)
    acc = tgt_leaves.new_zeros((n_slice, leaf_size, 3))
    pot = tgt_leaves.new_zeros((n_slice, leaf_size))
    rows, cols = torch.nonzero(valid, as_tuple=True)
    srcs = idx[rows, cols].long()
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
    return g * acc.reshape(n_out, 3), g * pot.reshape(n_out)


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
def near_items(counts, chunk):
    """K1's work items from the live length counts (L,) of front-packed
    near lists: every row is cut into ceil(count / chunk) items of at most
    `chunk` entries (an empty row into one empty item, which writes its
    zeros). Returns (items (n_items, 4) int32 [row, begin, end, dst],
    splits (n_split, 3) int32 [row, first, n], n_partial), items longest
    first (a stable sort, so a row's items keep their order among equals).
    dst is -1 for the single item of a row, which writes the row's output;
    the n items of a split row write partial slots first .. first + n - 1
    in chunk order, which `splits` names for the combining pass; n_partial
    slots in all.

    Index bookkeeping in a few torch ops on the lists' device; reading the
    three sizes back waits on the host once."""
    counts = counts.to(torch.int64)
    dev = counts.device
    n_chunks = torch.clamp((counts + chunk - 1) // chunk, min=1)
    split = n_chunks > 1
    split_n = torch.where(split, n_chunks, 0)
    n_items, n_partial, n_split = torch.stack(
        [n_chunks.sum(), split_n.sum(), split.sum()]).tolist()
    first_item = torch.cumsum(n_chunks, 0) - n_chunks
    first_slot = torch.cumsum(split_n, 0) - split_n
    rows = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                   n_chunks, output_size=n_items)
    k = torch.arange(n_items, device=dev) - first_item[rows]
    begin = k * chunk
    end = torch.minimum(begin + chunk, counts[rows])
    dst = torch.where(split[rows], first_slot[rows] + k, -1)
    order = torch.sort(end - begin, descending=True, stable=True).indices
    items = torch.stack([rows, begin, end, dst], dim=1)[order]
    # The split rows in ascending order, without a sync of their own.
    split_rows = torch.sort((~split).to(torch.int8), stable=True).indices[
        :n_split]
    splits = torch.stack([split_rows, first_slot[split_rows],
                          n_chunks[split_rows]], dim=1)
    return NearWork(items.to(torch.int32).contiguous(),
                    splits.to(torch.int32).contiguous(), n_partial)


def near_work(valid):
    """K1's work items (`near_items`, NEAR_CHUNK entries at most) for the
    front-packed near lists whose mask is valid (L, B), where a row's valid
    count is its live length. Built once per list build, next to the list
    builder, so that lists evaluated several times (the rebuild-interval
    runs) wait on the host once, not once a step. None for CPU lists:
    `near_field_plain` needs no items."""
    if valid.device.type == "cpu":
        return None
    return near_items(torch.sum(valid, dim=1), NEAR_CHUNK)


def near_field(pos_s, mass_s, tgt_leaves, idx, valid, *, g, softening,
               compute_pot=True, work=None):
    """K1: exact near field of targets (L, G, 3) against their front-packed
    ascending lists of source leaves idx (L, B) int32 / valid (L, B) bool
    over the sorted particles pos_s (n_pad, 3), mass_s (n_pad,). Returns
    (acc (L*G, 3), pot (L*G,)). CPU tensors run `near_field_plain`; CUDA
    tensors launch the kernel (f32 only) on the work items `work`
    (`near_work(valid)`, built here when None) and a packed (n_pad, 4)
    [x, y, z, m] source table."""
    if on_cpu(pos_s, mass_s, tgt_leaves, idx, valid):
        return near_field_plain(pos_s, mass_s, tgt_leaves, idx, valid, g=g,
                                softening=softening, compute_pot=compute_pot)
    n_slice, leaf_size, _ = tgt_leaves.shape
    n_pad = pos_s.shape[0]
    budget = idx.shape[1]
    if n_pad % leaf_size or not 0 < leaf_size <= 1024:
        raise ValueError(f"leaf size {leaf_size} must divide {n_pad} and be "
                         "at most 1024")
    check("pos_s", pos_s, torch.float32, (n_pad, 3))
    check("mass_s", mass_s, torch.float32, (n_pad,))
    check("tgt_leaves", tgt_leaves, torch.float32, (n_slice, leaf_size, 3))
    check("idx", idx, torch.int32, (n_slice, budget))
    check("valid", valid, torch.bool, (n_slice, budget))
    dev = pos_s.device
    items, splits, n_partial = near_work(valid) if work is None else work
    check("work.items", items, torch.int32, (items.shape[0], 4))
    check("work.splits", splits, torch.int32, (splits.shape[0], 3))
    table = torch.cat([pos_s, mass_s[:, None]], dim=1)
    partial = torch.empty((n_partial, leaf_size, 4), dtype=torch.float32,
                          device=dev)
    acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                      device=dev)
    pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32, device=dev)
    launch(LAUNCHES, "near_field", "pnb_near_field",
           ptr(table), ptr(tgt_leaves), ptr(idx), ptr(items), ptr(splits),
           ptr(acc), ptr(pot), ptr(partial), items.shape[0],
           splits.shape[0], leaf_size, budget, float(g),
           float(softening) ** 2, int(softening == 0.0),
           int(bool(compute_pot)))
    return acc, pot


def far_octet(tgt_leaves, nodes8, keys, valid, *, g, softening,
              compute_pot=True):
    """K2: octet-masked multipole far field of targets (L, G, 3) against
    their front-packed lists of (octet_id << 8) | child_mask keys (L, B)
    int32 / valid (L, B) bool over the 8-row-aligned node table nodes8
    (n8, 4|9). Returns (acc (L*G, 3), pot (L*G,)). CPU tensors run
    `far_octet_plain`; CUDA tensors launch the kernel (f32 only)."""
    if on_cpu(tgt_leaves, nodes8, keys, valid):
        return far_octet_plain(tgt_leaves, nodes8, keys, valid, g=g,
                               softening=softening, compute_pot=compute_pot)
    n_slice, leaf_size, _ = tgt_leaves.shape
    n8, n_comp = nodes8.shape
    budget = keys.shape[1]
    if n8 % 8 or n_comp not in (4, 9):
        raise ValueError(f"nodes8 {tuple(nodes8.shape)}: rows must be a "
                         "multiple of 8 and columns 4 or 9")
    if not 0 < leaf_size <= 1024:
        raise ValueError(f"leaf size {leaf_size} above 1024 (one thread "
                         "per target)")
    check("tgt_leaves", tgt_leaves, torch.float32, (n_slice, leaf_size, 3))
    check("nodes8", nodes8, torch.float32, (n8, n_comp))
    check("keys", keys, torch.int32, (n_slice, budget))
    check("valid", valid, torch.bool, (n_slice, budget))
    counts = torch.sum(valid, dim=1, dtype=torch.int32)
    acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                      device=nodes8.device)
    pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32,
                      device=nodes8.device)
    launch(LAUNCHES, "far_octet", "pnb_far_octet",
           ptr(nodes8), ptr(tgt_leaves), ptr(keys), ptr(counts),
           ptr(acc), ptr(pot), n_slice, leaf_size, budget, n_comp,
           float(g), float(softening) ** 2, int(softening == 0.0),
           int(bool(compute_pot)))
    return acc, pot


def far_gather(tgt_leaves, table, idx, valid, *, g, softening,
               compute_pot=True, front_packed=True):
    """K4: multipole far field of targets (L, G, 3) against their lists of
    node rows idx (L, B) int32 / valid (L, B) bool over table
    (n_nodes, 4|9). front_packed=True: each row's valid entries come first
    and the kernel walks only those; front_packed=False: `valid` is a
    scattered mask and every entry is walked and masked. Returns
    (acc (L*G, 3), pot (L*G,)). CPU tensors run `far_gather_plain`; CUDA
    tensors launch the kernel (f32 only)."""
    if on_cpu(tgt_leaves, table, idx, valid):
        return far_gather_plain(tgt_leaves, table, idx, valid, g=g,
                                softening=softening, compute_pot=compute_pot)
    n_slice, leaf_size, _ = tgt_leaves.shape
    n_nodes, n_comp = table.shape
    budget = idx.shape[1]
    if n_comp not in (4, 9):
        raise ValueError(f"table {tuple(table.shape)}: columns must be 4 "
                         "or 9")
    if not 0 < leaf_size <= 1024:
        raise ValueError(f"leaf size {leaf_size} above 1024 (one thread "
                         "per target)")
    check("tgt_leaves", tgt_leaves, torch.float32, (n_slice, leaf_size, 3))
    check("table", table, torch.float32, (n_nodes, n_comp))
    check("idx", idx, torch.int32, (n_slice, budget))
    check("valid", valid, torch.bool, (n_slice, budget))
    counts = torch.sum(valid, dim=1, dtype=torch.int32)
    acc = torch.empty((n_slice * leaf_size, 3), dtype=torch.float32,
                      device=table.device)
    pot = torch.empty((n_slice * leaf_size,), dtype=torch.float32,
                      device=table.device)
    launch(LAUNCHES, "far_gather", "pnb_far_gather",
           ptr(table), ptr(tgt_leaves), ptr(idx), ptr(valid), ptr(counts),
           ptr(acc), ptr(pot), n_slice, leaf_size, budget, n_comp,
           float(g), float(softening) ** 2, int(softening == 0.0),
           int(bool(compute_pot)), int(not front_packed))
    return acc, pot
