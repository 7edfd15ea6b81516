"""Barnes-Hut gravity: Hilbert sort + multipole pyramid + level-synchronous
masked traversal + per-target interaction lists, in torch.

Counterpart of `parallelnbody_tpu/ops/bh.py`, for both refinements and
either far field, unsectioned or in target windows:

  1. Hilbert-sort particles (ops/hilbert.py; Morton optional); the sorted
     order is the octree linearization.
  2. Group particles into fixed-size leaves and build a multipole pyramid
     (mass, CoM, bounding radius, traceless quadrupole) by reshape-reductions.
  3. Level-synchronous traversal with dense boolean masks over the upper
     levels; the group MAC accepts a node or expands its children.
  4. Candidates are split into exact near pairs and far multipoles, either
     on the dense (n_slice, n_leaves) leaf plane (refine="dense", the auto
     below 8192 leaves) or by staged refinement (refine="staged"): per
     target, a list of rejected level-2 nodes, their level-1 children
     tested and the rejected ones listed, their leaf children tested.
     far_mode="octet" (the auto) keys every far node as
     (octet_id << 8) | child_mask over the 8-aligned node table;
     far_mode="gather" lists node rows (dense: the accepted upper nodes and
     the accepted leaves; staged: one list over every level's table).
  5. The lists go to the hand-written kernels (ops/bh_kernels.py): K1 the
     near field, K2 the octet far field, K4 the gather far lists. List
     budget overflow is reported, never silently dropped.
  6. sections > 1 evaluates the target leaves in that many windows, one
     after the other, each through the same windowed traversal and lists;
     the results and the overflow count are those of one window over all.

Each phase of a force evaluation is a span (utils/profiling.span):
`bh.sort` (keys, sort, gather), `bh.tree`, `bh.traverse`, `bh.lists` (the
lists with K1's work items, and in a plan K2's launch order),
`bh.refresh` (a frozen-list evaluation's pyramid), `bh.unsort`; the kernel
wrappers' `bh.near` and `bh.far` (ops/bh_kernels.py).

Integer outputs (keys, sort order, masks, lists, overflow) equal the JAX
package's on the same inputs; `INT32_MAX` stays the empty-entry sentinel.

The acceptance criterion is the conservative group MAC
    MAC_SIZE_SCALE * r_node < theta * (d - r_leaf)
with r_* tight bounding radii around each group's center of mass.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from parallelnbody_tpu_torch.kernels.launch import COUNTERS, host_read
from parallelnbody_tpu_torch.ops import bh_kernels
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode
from parallelnbody_tpu_torch.ops.morton import morton_encode
from parallelnbody_tpu_torch.utils.profiling import span

INT32_MAX = 2**31 - 1


class BHTree(NamedTuple):
    """Per-level multipole pyramid over curve-sorted leaves. Index 0 =
    leaves, index -1 = root. Each level: com (n_k, 3), mass (n_k,),
    radius (n_k,), quad (n_k, 5) traceless quadrupole
    [Qxx, Qyy, Qxy, Qxz, Qyz] about the CoM (Qzz = -Qxx - Qyy);
    quad is a tuple of Nones when built with multipole order 1."""

    com: tuple
    mass: tuple
    radius: tuple
    quad: tuple

    @property
    def n_levels(self):
        return len(self.com)


def plan_tree(n: int, leaf_size: int, max_levels: int = 12):
    """Static plan: (n_leaves, n_padded, n_levels). n_leaves is the next
    power of two (max 2x particle padding); tree levels shrink by 8 where
    divisible, else by the remaining factor (mixed radix at the top)."""
    n_leaves_min = -(-n // leaf_size)
    n_leaves = max(8, 1 << math.ceil(math.log2(n_leaves_min)))
    levels, n_k = 1, n_leaves
    while n_k > 1 and levels < max_levels:
        n_k //= 8 if n_k % 8 == 0 and n_k >= 8 else n_k
        levels += 1
    return n_leaves, n_leaves * leaf_size, levels


def domain_cube(lo, hi):
    """(center, half, sentinel) of the key-quantization cube from a particle
    bounding box."""
    center = 0.5 * (lo + hi)
    half = torch.clamp(torch.max(0.5 * (hi - lo)), min=1e-12) * (1 + 1e-6)
    return center, half, center + 4.0 * half


def _quad_about(d, w):
    """Traceless quadrupole [Qxx, Qyy, Qxy, Qxz, Qyz] of weighted
    displacements d: (..., K, 3), w: (..., K) -> (..., 5)."""
    d2 = torch.sum(d * d, dim=-1)
    qxx = torch.sum(w * (3 * d[..., 0] * d[..., 0] - d2), dim=-1)
    qyy = torch.sum(w * (3 * d[..., 1] * d[..., 1] - d2), dim=-1)
    qxy = torch.sum(w * 3 * d[..., 0] * d[..., 1], dim=-1)
    qxz = torch.sum(w * 3 * d[..., 0] * d[..., 2], dim=-1)
    qyz = torch.sum(w * 3 * d[..., 1] * d[..., 2], dim=-1)
    return torch.stack([qxx, qyy, qxy, qxz, qyz], dim=-1)


def _norm3(d):
    return torch.sqrt(torch.sum(d * d, dim=-1))


def build_tree(pos_sorted, mass_sorted, leaf_size: int, sentinel,
               multipole_order: int = 1, max_levels: int = 12) -> BHTree:
    """Multipole pyramid from curve-sorted particles.

    multipole_order: 1 = monopole only; 2 = + traceless quadrupoles
    (propagated upward with the parallel-axis shift). Zero-mass (padding)
    members are excluded from CoM/radius; empty nodes get CoM = sentinel
    (far outside the domain) so they pass the MAC and contribute nothing.
    """
    n_pad = pos_sorted.shape[0]
    n_leaves = n_pad // leaf_size

    p = pos_sorted.reshape(n_leaves, leaf_size, 3)
    m = mass_sorted.reshape(n_leaves, leaf_size)
    msum = torch.sum(m, dim=1)
    com = torch.where(
        (msum > 0)[:, None],
        torch.sum(m[:, :, None] * p, dim=1) / torch.clamp(msum, min=1e-30)[:, None],
        sentinel[None, :],
    )
    d = p - com[:, None, :]
    radius = torch.amax(torch.where(m > 0, _norm3(d), 0.0), dim=1)
    quad = _quad_about(d, m) if multipole_order >= 2 else None

    return build_upper(com, msum, radius, quad, sentinel,
                       max_levels=max_levels)


def build_upper(com, mass, radius, quad, sentinel, *,
                max_levels: int = 12) -> BHTree:
    """Upper multipole pyramid from a leaf-level summary table (level 0 of
    the result). quad=None builds a monopole pyramid."""
    coms, masses, radii, quads = [com], [mass], [radius], [quad]
    while coms[-1].shape[0] > 1 and len(coms) < max_levels:
        n_k = coms[-1].shape[0]
        b = 8 if (n_k % 8 == 0 and n_k >= 8) else n_k
        c = coms[-1].reshape(-1, b, 3)
        mm = masses[-1].reshape(-1, b)
        rr = radii[-1].reshape(-1, b)
        msum_k = torch.sum(mm, dim=1)
        com_k = torch.where(
            (msum_k > 0)[:, None],
            torch.sum(mm[:, :, None] * c, dim=1)
            / torch.clamp(msum_k, min=1e-30)[:, None],
            sentinel[None, :],
        )
        sdisp = c - com_k[:, None, :]
        spread = _norm3(sdisp) + rr
        rad_k = torch.amax(torch.where(mm > 0, spread, 0.0), dim=1)
        if quads[-1] is not None:
            qk = torch.sum(quads[-1].reshape(-1, b, 5), dim=1)
            qk = qk + _quad_about(sdisp, mm)
            quads.append(qk)
        else:
            quads.append(None)
        coms.append(com_k)
        masses.append(msum_k)
        radii.append(rad_k)

    return BHTree(com=tuple(coms), mass=tuple(masses), radius=tuple(radii),
                  quad=tuple(quads))


# MAC size constant (the JAX package's value): the node's "size" in
# `size/d < theta` is MAC_SIZE_SCALE * bounding_radius.
MAC_SIZE_SCALE = 1.0


def _group_mac(leaf_com, leaf_r, node_com, node_r, theta):
    """(n_leaves, n_k) True where the node multipole is acceptable for
    every particle in the target leaf (target radius subtracted from the
    separation). Distances accumulate component-wise, as in the JAX
    package, so the comparison rounds the same way."""
    d2 = torch.zeros((leaf_com.shape[0], node_com.shape[0]),
                     dtype=leaf_com.dtype, device=leaf_com.device)
    for c in range(3):
        dc = node_com[:, c][None, :] - leaf_com[:, c][:, None]
        d2 = d2 + dc * dc
    d_eff = torch.sqrt(d2) - leaf_r[:, None]
    return (MAC_SIZE_SCALE * node_r[None, :]) < (theta * d_eff)


def traverse(tree: BHTree, theta: float, *, start_leaf=0, n_slice=None,
             stop_level=1):
    """Level-synchronous masked traversal over the upper levels
    (k >= stop_level), for the target-leaf slice
    [start_leaf, start_leaf + n_slice) (defaults to all leaves).

    Returns (far_masks, rejects): far_masks[k] is the (n_slice, n_k) bool
    mask of level-k nodes accepted as multipoles (lower indices None);
    rejects is the (n_slice, n_stop) mask of stop-level nodes to refine."""
    leaf_com, leaf_r = tree.com[0], tree.radius[0]
    n_levels = tree.n_levels
    if not 0 < stop_level < n_levels:
        raise ValueError(f"stop_level {stop_level} outside (0, {n_levels})")
    if n_slice is None:
        n_slice = leaf_com.shape[0]
    tgt_com = leaf_com[start_leaf:start_leaf + n_slice]
    tgt_r = leaf_r[start_leaf:start_leaf + n_slice]

    far_masks = [None] * n_levels
    active = torch.ones((n_slice, tree.com[-1].shape[0]), dtype=torch.bool,
                        device=leaf_com.device)
    for k in range(n_levels - 1, stop_level, -1):
        mac = _group_mac(tgt_com, tgt_r, tree.com[k], tree.radius[k], theta)
        far_masks[k] = active & mac
        branch = tree.com[k - 1].shape[0] // tree.com[k].shape[0]
        active = (active & ~mac).repeat_interleave(branch, dim=1)
    mac_s = _group_mac(tgt_com, tgt_r, tree.com[stop_level],
                       tree.radius[stop_level], theta)
    far_masks[stop_level] = active & mac_s
    rejects = active & ~mac_s
    return far_masks, rejects


def _iota(n_rows, n_cols, device):
    """(n_rows, n_cols) int32 column indices."""
    return torch.arange(n_cols, dtype=torch.int32,
                        device=device)[None, :].expand(n_rows, n_cols)


def _keys_compact(keys, budget, need=None, kind=None):
    """Front-pack the finite (!= INT32_MAX) int32 keys of each row into a
    padded ascending (n_rows, budget) list by one row sort. Returns
    (idx, valid, overflow). The counts and the overflow are int64, the
    dtype of K1's item sizes, in whose read a clip is seen
    (bh_kernels.near_items): summed into that dtype from the mask, they
    need no cast of their own. need: a dict that gains, under `kind` (a key
    of BUDGET_FIELDS), each row's count of keys before the clip (list_needs
    reads it); no device work of its own."""
    n_rows, n_cols = keys.shape
    budget = min(budget, n_cols)
    counts = torch.sum(keys != INT32_MAX, dim=1, dtype=torch.int64)
    if need is not None:
        need.setdefault(kind, []).append(counts)
    overflow = torch.sum(torch.clamp(counts - budget, min=0),
                         dtype=torch.int64)
    idx = torch.sort(keys, dim=1).values[:, :budget]
    valid = _iota(n_rows, budget, keys.device) < counts[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid, overflow


def _row_compact(mask, fill_idx, budget, need=None, kind=None):
    """Front-pack the True column-values of `fill_idx` per row into a padded
    (n_rows, budget) list. Returns (idx, valid, overflow); ascending when
    fill_idx rows are. need, kind: as _keys_compact's."""
    return _keys_compact(
        torch.where(mask, fill_idx, torch.full_like(fill_idx, INT32_MAX)),
        budget, need, kind)


def _dense_leaf_masks(tree: BHTree, rejects_l1, theta, start_leaf, n_slice):
    """(near_mask, far_mask) (n_slice, n_leaves) bool planes splitting the
    candidate leaves (children of rejected level-1 nodes) by the leaf-level
    MAC. Zero-mass (padding) target leaves get empty rows."""
    leaf_com, leaf_r = tree.com[0], tree.radius[0]
    n_leaves = leaf_com.shape[0]
    branch = n_leaves // tree.com[1].shape[0]

    if rejects_l1.shape[0] != n_slice:
        raise ValueError(f"rejects rows {rejects_l1.shape[0]} != {n_slice}")
    tgt_com = leaf_com[start_leaf:start_leaf + n_slice]
    tgt_r = leaf_r[start_leaf:start_leaf + n_slice]

    d2 = torch.zeros((n_slice, n_leaves), dtype=leaf_com.dtype,
                     device=leaf_com.device)
    for c in range(3):
        dc = leaf_com[:, c][None, :] - tgt_com[:, c][:, None]
        d2 = d2 + dc * dc
    d = torch.sqrt(d2)
    mac0 = (MAC_SIZE_SCALE * leaf_r[None, :]) < (theta * (d - tgt_r[:, None]))

    # Candidates = children of rejected level-1 nodes: column j is a
    # candidate iff rejects_l1[:, j // branch].
    cand_valid = rejects_l1[:, :, None].expand(
        n_slice, n_leaves // branch, branch).reshape(n_slice, n_leaves)
    tgt_m = tree.mass[0][start_leaf:start_leaf + n_slice]
    cand_valid = cand_valid & (tgt_m > 0)[:, None]
    return cand_valid & ~mac0, cand_valid & mac0


def leaf_interactions(tree: BHTree, rejects_l1, theta: float, *,
                      start_leaf, n_slice, near_budget: int,
                      far0_budget: int, need=None):
    """Refine rejected level-1 nodes to leaf granularity for the target-leaf
    slice [start_leaf, start_leaf + n_slice) through the dense leaf plane:
    front-packed lists of exact near leaves and of accepted leaf monopoles
    (far0). Returns (near_idx, near_valid, far0_idx, far0_valid,
    overflow). need: as _keys_compact's (kinds "near" and "far")."""
    near_mask, far_mask = _dense_leaf_masks(tree, rejects_l1, theta,
                                            start_leaf, n_slice)
    cols = _iota(n_slice, tree.com[0].shape[0], near_mask.device)
    near_idx, near_valid, of_n = _row_compact(near_mask, cols, near_budget,
                                              need, "near")
    far0_idx, far0_valid, of_f = _row_compact(far_mask, cols, far0_budget,
                                              need, "far")
    return near_idx, near_valid, far0_idx, far0_valid, of_n + of_f


# ------------------------------------------------ octet-masked far lists
# Every far-accepted node, at any level, lies in an aligned 8-sibling octet
# of its level's node table (levels are padded to multiples of 8 rows). A
# far list entry is one int32 key (octet_id << 8) | child_mask.

def _node_table(tree: BHTree, k: int, dtype):
    """(n_k, 4|9) [com, mass(, quad)] rows of level k, the far kernel's
    multipole format."""
    cols = [tree.com[k], tree.mass[k][:, None]]
    if tree.quad[0] is not None:
        cols.append(tree.quad[k])
    return torch.cat(cols, dim=1).to(dtype)


def _octet_offsets(widths):
    """(offs8, n_octets): octet index of each level's first sibling octet in
    the 8-aligned combined table (_nodes_all_octet). Level k's node j lives
    in octet offs8[k] + j // 8, row j % 8."""
    offs8, o = [], 0
    for w in widths:
        offs8.append(o)
        o += -(-w // 8)
    return offs8, o


def _nodes_all_octet(tree: BHTree, dtype):
    """All levels' node tables stacked with every level padded to a multiple
    of 8 rows (pad rows are zero: mass 0 and quad 0 contribute nothing), so
    each node's 8-sibling octet is an aligned (8, C) tile."""
    parts = []
    for k in range(tree.n_levels):
        t = _node_table(tree, k, dtype)
        pad = (-t.shape[0]) % 8
        if pad:
            t = torch.cat([t, t.new_zeros((pad, t.shape[1]))], dim=0)
        parts.append(t)
    return torch.cat(parts, dim=0).contiguous()


def _octet_keys_dense(mask, oct_off):
    """Octet keys from a dense (n, n_k) acceptance mask: one int32 key
    (octet_id << 8) | child_mask per sibling octet with any accepted member,
    INT32_MAX elsewhere. Octet ids sit in the high bits, so keys sort
    ascending by octet."""
    n, w = mask.shape
    pad = (-w) % 8
    if pad:
        mask = torch.cat([mask, mask.new_zeros((n, pad))], dim=1)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    bits = torch.sum(mask.reshape(n, -1, 8).to(torch.int32) * weights,
                     dim=2, dtype=torch.int32)
    octs = oct_off + _iota(n, bits.shape[1], mask.device)
    return torch.where(bits > 0, (octs << 8) | bits,
                       torch.full_like(bits, INT32_MAX))


def _octet_upper_keys(far_masks, offs8, n_levels, lo_level=2):
    """Accepted upper-level (k >= lo_level) nodes as octet key columns."""
    return torch.cat(
        [_octet_keys_dense(far_masks[k], offs8[k])
         for k in range(lo_level, n_levels)], dim=1)


def build_interaction_lists_octet(tree, far_masks, rejects_l1, *, theta,
                                  start_leaf, n_slice, near_budget,
                                  far_budget, dtype, need=None):
    """Dense-refinement lists in octet-masked far form: ONE far list of
    (octet_id << 8) | child_mask keys covering every far class (upper
    accepted nodes, levels >= 1, and leaf-MAC-accepted candidates) over the
    8-aligned combined node table, plus the near list of source leaves.
    far_budget counts octet entries.

    Returns (near_idx, near_valid, far_keys, far_valid, nodes8, overflow);
    overflow counts near clips plus 8x clipped far octets. need: as
    _keys_compact's (kinds "near" and "far")."""
    near_mask, far_mask = _dense_leaf_masks(tree, rejects_l1, theta,
                                            start_leaf, n_slice)
    n_leaves = tree.com[0].shape[0]
    offs8, n_oct = _octet_offsets([c.shape[0] for c in tree.com])

    cols = _iota(n_slice, n_leaves, near_mask.device)
    near_idx, near_valid, of_n = _row_compact(near_mask, cols, near_budget,
                                              need, "near")

    # Phantom (zero-mass) targets: the leaf masks already exclude them; the
    # upper masks are blanked the same way.
    tgt_m = tree.mass[0][start_leaf:start_leaf + n_slice]
    upk = _octet_upper_keys(far_masks, offs8, tree.n_levels, lo_level=1)
    upk = torch.where((tgt_m > 0)[:, None], upk,
                      torch.full_like(upk, INT32_MAX))
    far_keys = torch.cat([_octet_keys_dense(far_mask, offs8[0]), upk], dim=1)
    far_keys, far_valid, of_f = _keys_compact(
        far_keys, min(far_budget, n_oct), need, "far")
    overflow = of_n + 8 * of_f
    return (near_idx, near_valid, far_keys, far_valid,
            _nodes_all_octet(tree, dtype), overflow)


def _eval_far_octet(tgt_leaves, nodes8, keys, valid, *, g, softening,
                    compute_pot=True, order=None):
    """Evaluate ONE octet-masked far list over the 8-aligned combined node
    table -> (acc, pot) flat over the window's particles (kernel K2, its
    leaves launched in `order`, bh_kernels.far_order)."""
    return bh_kernels.far_octet(tgt_leaves, nodes8, keys, valid, g=g,
                                softening=softening, compute_pot=compute_pot,
                                order=order)


# ------------------------------------------------- staged (hierarchical) lists
def _nodes_all(tree: BHTree, dtype):
    """All levels' node tables stacked: row offsets per _level_offsets."""
    return torch.cat([_node_table(tree, k, dtype)
                      for k in range(tree.n_levels)], dim=0).contiguous()


def _level_offsets(widths):
    """Global-id offset of each level's rows in _nodes_all."""
    offs = [0]
    for k in range(1, len(widths)):
        offs.append(offs[-1] + widths[k - 1])
    return offs


def _upper_keys(far_masks, offs, n_levels):
    """Accepted upper-level (k >= 2) nodes as global-id key columns
    (INT32_MAX = invalid), ready for a _keys_compact far sort."""
    return torch.cat(
        [torch.where(far_masks[k], offs[k] + _iota(*far_masks[k].shape,
                                                   far_masks[k].device),
                     INT32_MAX)
         for k in range(2, n_levels)], dim=1)


def _octet_keys_children(mask_b, parent_idx, child_oct_off, b):
    """Octet keys from per-candidate child masks mask_b (R, B, b) for
    parents parent_idx (R, B): node j's children are rows [j*b, (j+1)*b) of
    the child level.

    b <= 8 (a power of two): bits (j*b) % 8 .. of octet
    child_oct_off + j*b//8, one key per candidate, (R, B), as the JAX
    package emits them; a parent's children never straddle an octet.
    Parents with b < 8 may share an octet: their masks are disjoint, so
    such duplicate-octet entries count each child once, and the far kernels
    sum every entry.

    b > 8 comes only from a level collapsed into one node (build_upper: a
    width that is no multiple of 8), so parent_idx is 0 and the children
    start at an octet boundary and cover ceil(b / 8) octets: one key per
    covered octet, (R, B, ceil(b / 8)), key o being
    ((child_oct_off + o) << 8) | children 8o .. 8o + 7 of the mask. (The
    JAX package packs all b bits into one key there, and bits 8 and up
    carry into the octet id.)"""
    if b > 8:
        n_oct = -(-b // 8)
        pad = n_oct * 8 - b
        if pad:
            mask_b = torch.cat([mask_b, mask_b.new_zeros(
                mask_b.shape[:2] + (pad,))], dim=2)
        pw = 1 << torch.arange(8, dtype=torch.int32, device=mask_b.device)
        small = torch.sum(mask_b.reshape(mask_b.shape[:2] + (n_oct, 8))
                          .to(torch.int32) * pw, dim=3, dtype=torch.int32)
        octs = child_oct_off + torch.arange(n_oct, dtype=torch.int32,
                                            device=mask_b.device)
        return torch.where(small > 0, (octs << 8) | small, INT32_MAX)
    pw = 1 << torch.arange(b, dtype=torch.int32, device=mask_b.device)
    small = torch.sum(mask_b.to(torch.int32) * pw, dim=2, dtype=torch.int32)
    base = parent_idx * b
    keys = ((child_oct_off + base // 8) << 8) | (small << (base % 8))
    return torch.where(small > 0, keys, INT32_MAX)


# Bytes a staged row block may hold in its per-child temporaries. Each
# child slot of a candidate row, (R, B, b) for B candidates of b children,
# carries 80 bytes in the port's stage: the gathered (R, B, 5b) f32 child
# geometry (20), dx, dy, dz and d (16), the squares summed into d (12), the
# MAC, live, accepted and rejected masks (4), the child ids (4), the keys
# (4) and the row sort's int32 values and int64 indices (12), rounded up.
# 1 GiB a block leaves the lists themselves most of the card.
_STAGE_BLOCK_BYTES = 1 << 30
_STAGE_BYTES_PER_CHILD = 80


def _auto_row_block(child_slots):
    """Target rows a staged row block holds so that its per-child
    temporaries (child_slots a row) stay near _STAGE_BLOCK_BYTES."""
    per_row = max(child_slots, 1) * _STAGE_BYTES_PER_CHILD
    return max(8, _STAGE_BLOCK_BYTES // per_row)


def _map_row_blocks(fn, args, n_rows, row_block):
    """Apply fn over row blocks, one after the other, to bound the gathered
    temporaries. The block is n_rows halved while it exceeds row_block or
    does not divide n_rows (the JAX package's rule: single rows once it
    turns odd); joins the blocks' outputs along their leading dimension
    (scalar-per-block outputs come back as (n_blocks,): sum them)."""
    block = n_rows
    while block > row_block or (block > 1 and n_rows % block):
        block = block // 2 if block % 2 == 0 else 1
    if block == n_rows:
        return fn(args)
    outs = [fn(tuple(a[r0:r0 + block] for a in args))
            for r0 in range(0, n_rows, block)]
    return tuple(torch.cat(parts) if parts[0].ndim else torch.stack(parts)
                 for parts in zip(*outs))


def _child_pack(tree: BHTree, k: int):
    """Packed child-geometry table for refining level-k nodes: row j of the
    (n_k, 5*b) table holds node j's b children at level k-1 as
    [cx*b | cy*b | cz*b | r*b | m*b], so one row gather per (target,
    candidate) brings all b children at once."""
    n_child = tree.com[k - 1].shape[0]
    n_k = tree.com[k].shape[0]
    b = n_child // n_k
    cols = [tree.com[k - 1][:, 0], tree.com[k - 1][:, 1],
            tree.com[k - 1][:, 2], tree.radius[k - 1], tree.mass[k - 1]]
    return torch.cat([c.reshape(n_k, b) for c in cols], dim=1), b


def _refine_stage(pack, b, cand_idx, cand_valid, tgt_com, tgt_r, theta):
    """Gather each candidate node's packed children and test the group MAC
    per child. Returns (acc, rej, gid): (R, B, b) masks of children accepted
    as multipoles / needing further refinement, and their global child ids
    (ascending along flattened columns when cand_idx rows are ascending).
    Empty children (mass 0 => CoM = sentinel) are excluded from BOTH
    classes: they carry no physics. The distance sums its squares in the
    JAX package's order, so the f32 comparison rounds the same way."""
    rows = pack[cand_idx.long()]                 # (R, B, 5b)
    cx = rows[:, :, 0 * b:1 * b]
    cy = rows[:, :, 1 * b:2 * b]
    cz = rows[:, :, 2 * b:3 * b]
    cr = rows[:, :, 3 * b:4 * b]
    cm = rows[:, :, 4 * b:5 * b]
    dx = cx - tgt_com[:, 0][:, None, None]
    dy = cy - tgt_com[:, 1][:, None, None]
    dz = cz - tgt_com[:, 2][:, None, None]
    d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    mac = (MAC_SIZE_SCALE * cr) < (theta * (d - tgt_r[:, None, None]))
    live = cand_valid[:, :, None] & (cm > 0)
    gid = (cand_idx[:, :, None] * b
           + torch.arange(b, dtype=torch.int32, device=cand_idx.device))
    return live & mac, live & ~mac, gid


def build_interaction_lists_staged(tree: BHTree, far_masks, rejects_l2, *,
                                   theta, start_leaf, n_slice, near_budget,
                                   far_budget, cand2_budget, cand1_budget,
                                   dtype, row_block=0, octet_far=False,
                                   need=None):
    """Hierarchical candidate refinement: the staged replacement for the
    dense (n_slice, n_leaves) leaf plane, O(n_slice * budget) instead of
    O(n_slice * n_leaves), so n_leaves can grow past ~8-16k.

    Inputs come from traverse(stop_level=2): far_masks[k] for k >= 2 are
    the dense accepted-node masks (narrow: node counts shrink 8x per level)
    and rejects_l2 is the (n_slice, n_l2) mask of level-2 nodes needing
    refinement. Three stages, all row sorts and row gathers:

      A. compact rejects_l2 into a per-target candidate list (cand2_budget);
      B. gather each candidate's packed level-1 children (_child_pack) and
         MAC them: accepted -> far entries at level 1; rejected -> compact
         into a level-1 candidate list (cand1_budget);
      C. gather level-1 candidates' packed leaf children and MAC them:
         accepted -> far entries at level 0; rejected -> the exact near list.

    ONE far list covers everything non-near (upper accepted nodes from the
    dense masks, level-1 accepts, leaf accepts) as ascending global ids into
    the combined node table nodes_all = [leaves | level1 | level2 | ...]
    (returned); `far_budget` must cover their SUM per target. Returns
    (near_idx, near_valid, far_idx, far_valid, nodes_all, overflow); near
    ids are leaf ids as in the dense path, so K1 serves both. Overflow is
    an UPPER BOUND on lost entries: candidate-list clips count the clipped
    candidate's worst-case subtree size (b2*b1 per level-2 clip, b1 per
    level-1 clip) since its live-descendant count is unknown at clip time,
    plus exact near/far clips.

    row_block: process targets in row blocks, one after the other, to
    bound the gathered temporaries (0 = auto, _auto_row_block); blocking
    changes no bit of the lists.

    octet_far=True: the far list is emitted in octet-masked form, keys
    (octet_id << 8) | child_mask over the 8-aligned combined table
    (_nodes_all_octet, returned in place of _nodes_all); far_budget counts
    octet entries, and a clipped far entry counts 8 into the overflow. The
    stage masks are per-parent child masks, so emission is a bit-pack.

    need: as _keys_compact's, for the four kinds of BUDGET_FIELDS. A
    clipped candidate list under-counts the stages after it."""
    n_levels = tree.n_levels
    widths = [c.shape[0] for c in tree.com]
    if n_levels < 3:
        raise ValueError("staged refinement needs >= 3 tree levels")
    offs = _level_offsets(widths)
    offs8, n_oct = _octet_offsets(widths)

    pack2, b2 = _child_pack(tree, 2)
    pack1, b1 = _child_pack(tree, 1)
    cand2_budget = min(cand2_budget, widths[2])
    cand1_budget = min(cand1_budget, widths[1])
    if octet_far:
        far_budget = min(far_budget, n_oct)

    window = slice(start_leaf, start_leaf + n_slice)
    tgt_com = tree.com[0][window]
    tgt_r = tree.radius[0][window]
    tgt_m = tree.mass[0][window]
    up_keys = (_octet_upper_keys(far_masks, offs8, n_levels) if octet_far
               else _upper_keys(far_masks, offs, n_levels))

    def block_fn(args):
        rej2, upk, t_com, t_r, t_m = args
        r = rej2.shape[0]
        # Zero-mass (padding) target leaves get empty lists: phantom
        # targets must not consume budgets.
        rej2 = rej2 & (t_m > 0)[:, None]
        upk = torch.where((t_m > 0)[:, None], upk, INT32_MAX)
        cols2 = _iota(*rej2.shape, rej2.device)
        c2_idx, c2_valid, of2 = _row_compact(rej2, cols2, cand2_budget,
                                             need, "cand2")

        acc1, rej1, gid1 = _refine_stage(pack2, b2, c2_idx, c2_valid,
                                         t_com, t_r, theta)
        c1_idx, c1_valid, of1 = _keys_compact(
            torch.where(rej1, gid1, INT32_MAX).reshape(r, -1), cand1_budget,
            need, "cand1")

        acc0, near0, gid0 = _refine_stage(pack1, b1, c1_idx, c1_valid,
                                          t_com, t_r, theta)
        near_keys = torch.where(near0, gid0, INT32_MAX).reshape(r, -1)
        near_idx, near_valid, of_n = _keys_compact(near_keys, near_budget,
                                                   need, "near")

        if octet_far:
            far1_keys = _octet_keys_children(acc1, c2_idx, offs8[1], b2)
            far0_keys = _octet_keys_children(acc0, c1_idx, offs8[0], b1)
        else:
            far1_keys = torch.where(acc1, offs[1] + gid1, INT32_MAX)
            far0_keys = torch.where(acc0, gid0, INT32_MAX)
        far_idx, far_valid, of_f = _keys_compact(
            torch.cat([far0_keys.reshape(r, -1), far1_keys.reshape(r, -1),
                       upk], dim=1), far_budget, need, "far")
        if octet_far:
            of_f = of_f * 8  # a clipped octet hides up to 8 nodes
        # A clipped candidate hides up to b children from BOTH classes.
        of = of2 * (b2 * b1) + of1 * b1 + of_n + of_f
        return near_idx, near_valid, far_idx, far_valid, of

    if row_block <= 0:
        row_block = _auto_row_block(max(cand1_budget * b1,
                                        cand2_budget * b2))
    near_idx, near_valid, far_idx, far_valid, of = _map_row_blocks(
        block_fn, (rejects_l2, up_keys, tgt_com, tgt_r, tgt_m), n_slice,
        row_block)
    overflow = torch.sum(of, dtype=torch.int64)
    nodes = (_nodes_all_octet(tree, dtype) if octet_far
             else _nodes_all(tree, dtype))
    return near_idx, near_valid, far_idx, far_valid, nodes, overflow


# ------------------------------------------------------ gather far lists
def build_interaction_lists(tree, far_masks, rejects_l1, *, theta, start_leaf,
                            n_slice, near_budget, far0_budget, dtype,
                            need=None):
    """Dense-refinement lists in gather form for one target window: the near
    list, the far0 list of accepted leaves over the leaf node table, and
    the list of accepted upper nodes (levels >= 1) over their stacked node
    table. The upper acceptance mask is narrow, so it is compacted at full
    width and cannot clip; far0_budget counts leaf entries.

    Returns (near_idx, near_valid, far0_idx, far0_valid, up_idx, up_valid,
    nodes_up, leaf_nodes, overflow). need: as leaf_interactions'."""
    near_idx, near_valid, far0_idx, far0_valid, overflow = leaf_interactions(
        tree, rejects_l1, theta, start_leaf=start_leaf, n_slice=n_slice,
        near_budget=near_budget, far0_budget=far0_budget, need=need)
    up_idx, up_valid, nodes_up, leaf_nodes = _upper_list(tree, far_masks,
                                                         dtype)
    return (near_idx, near_valid, far0_idx, far0_valid, up_idx, up_valid,
            nodes_up, leaf_nodes, overflow)


def _upper_list(tree, far_masks, dtype):
    """The gather form's upper far class: the accepted nodes of levels >= 1
    compacted at full width over their stacked node table, and the leaf
    node table. Returns (up_idx, up_valid, nodes_up, leaf_nodes)."""
    nodes_up = torch.cat(
        [_node_table(tree, k, dtype) for k in range(1, tree.n_levels)], dim=0)
    up_mask = torch.cat([far_masks[k] for k in range(1, tree.n_levels)],
                        dim=1)
    cols_up = _iota(*up_mask.shape, up_mask.device)
    up_idx, up_valid, _ = _row_compact(up_mask, cols_up, nodes_up.shape[0])
    return up_idx, up_valid, nodes_up, _node_table(tree, 0, dtype)


def _eval_far_list(tgt_leaves, table, idx, valid, *, g, softening,
                   compute_pot=True, order=None):
    """Evaluate ONE front-packed per-target list of node rows over `table`
    ([com, mass] or [com, mass, quad]) -> (acc, pot) flat over the window's
    particles (kernel K4, its leaves launched in `order`,
    bh_kernels.far_order)."""
    return bh_kernels.far_gather(tgt_leaves, table, idx, valid, g=g,
                                 softening=softening, compute_pot=compute_pot,
                                 order=order)


def eval_far_lists(tgt_leaves, nodes_up, up_idx, up_valid, leaf_nodes,
                   far0_idx, far0_valid, *, g, softening, compute_pot=True):
    """Both dense gather far classes for one target window, each a list of
    node rows evaluated by K4, summed in the JAX package's order: the upper
    nodes, then the accepted leaves."""
    kw = dict(g=g, softening=softening, compute_pot=compute_pot)
    acc, pot = _eval_far_list(tgt_leaves, nodes_up, up_idx, up_valid, **kw)
    a, ph = _eval_far_list(tgt_leaves, leaf_nodes, far0_idx, far0_valid,
                           **kw)
    return acc + a, pot + ph


# -------------------------------------------------------------- budget heal
# The list budgets by the kind of list they size, as a list build records
# its needs: the near list, the far list (octet entries, or node rows in
# the gather form), the staged level-2 and level-1 candidate lists.
BUDGET_FIELDS = {"near": "bh_near_budget", "far": "bh_far_budget",
                 "cand2": "bh_cand2_budget", "cand1": "bh_cand_budget"}
# Calibration's rule (api.calibrate_budgets): the measured need, +25% and
# at least one lane more, rounded up to the kind's lane.
BUDGET_LANES = {"near": 128, "far": 128, "cand2": 64, "cand1": 64}
BUDGET_HEADROOM = 1.25
# Rebuilds by calibration's rule before a budget that still clips takes
# twice calibration's budget for its need (at most its full width). A
# clipped candidate list under-counts the stages after it, so a staged
# build can need one round a stage: cand2's need is exact at once (it
# comes from the traversal), cand1's once cand2 holds, near's and far's
# once cand1 holds, so 3 rounds at most and the doubling is a guard.
HEAL_ROUNDS = 4


def pad_budget(need, mult, headroom=BUDGET_HEADROOM):
    """The budget that holds `need` entries by calibration's rule:
    `headroom` over it and one lane `mult` of slack at least, rounded up to
    a multiple of the lane."""
    target = max(int(need * headroom), int(need) + mult)
    return max(mult, -(-target // mult) * mult)


def list_needs(need) -> dict:
    """{kind: the most entries any target's list of that kind needed}, from
    the row counts a list build recorded in `need` (_keys_compact), in one
    read: a counted wait on the device (launch.host_read) for CUDA counts."""
    kinds = sorted(need)
    maxima = torch.stack([torch.max(torch.cat(need[k])) for k in kinds])
    read = host_read if maxima.device.type == "cuda" else torch.Tensor.tolist
    return dict(zip(kinds, read(maxima)))


def _full_widths(tree: BHTree) -> dict:
    """A budget of each kind at which no list of `tree` clips: the
    list functions clamp each to its list's width."""
    widths = [c.shape[0] for c in tree.com]
    return {"near": widths[0], "far": sum(widths), "cand1": widths[1],
            "cand2": widths[2] if len(widths) > 2 else widths[1]}


def _clip_count(work, overflow) -> int:
    """A list build's clip counter on the host: read with K1's item sizes
    on the card (NearWork.overflow), from the CPU tensor on the CPU."""
    return work.overflow if work is not None else int(overflow)


class ListHeal:
    """The list budgets that calibration chose for the Barnes-Hut callables
    that share this heal (api.make_step's step, api._make_run_reuse's run,
    api.Simulation's diagnostics), grown where a list build clips one.

    build() runs a list build; where it clipped, the needs it measured are
    read (list_needs), each clipped budget of `kinds` grows by
    calibration's rule (pad_budget; after HEAL_ROUNDS rounds to twice
    that) up to its full width and the lists are built again, in a
    `bh.heal` span and counted in COUNTERS["bh.heals"], until no budget of
    `kinds` clips. The grown budgets stay for every later build of the
    callables that share the heal (`grown`; api.Simulation shares one
    between its step, runs and diagnostics). Budgets the caller set are
    never grown: their clips stay in the overflow."""

    def __init__(self, kinds):
        self.kinds = frozenset(kinds)
        self.grown = {}     # kind -> budget, for every later build

    @classmethod
    def of(cls, cfg) -> "ListHeal | None":
        """The heal of cfg's calibrated budgets (SimConfig.
        calibrated_budgets); None where calibration chose none."""
        kinds = [k for k, f in BUDGET_FIELDS.items()
                 if f in cfg.calibrated_budgets]
        return cls(kinds) if kinds else None

    def build(self, build, budgets: dict, full: dict):
        """The lists of build(budgets, need) -> (lists, clip count on the
        host), built at `budgets` (a dict by kind) with the grown ones in
        place, and again while a budget of `kinds` clips. `full`: each
        kind's full width (_full_widths)."""
        budgets = {**budgets, **self.grown}
        need = {}
        lists, clipped = build(budgets, need)
        rounds = 0
        while clipped:
            needs = list_needs(need)
            times = 2 if rounds >= HEAL_ROUNDS else 1
            grown = {k: min(times * pad_budget(needs[k], BUDGET_LANES[k]),
                            full[k])
                     for k in self.kinds
                     if needs.get(k, 0) > budgets[k] and budgets[k] < full[k]}
            if not grown:
                break
            rounds += 1
            COUNTERS["bh.heals"] += 1
            self.grown.update(grown)
            budgets.update(grown)
            lists = None            # the clipped lists go before the rebuild
            with span("bh.heal"):
                need = {}
                lists, clipped = build(budgets, need)
        return lists


# ------------------------------------------------------------------- assembly
def _prepare(pos, mass, *, leaf_size, curve, multipole_order=1, max_levels=12):
    """Pad, curve-sort, and build the multipole pyramid. Returns
    (pos_s, mass_s, perm, tree, n, n_pad); perm[i] is the original row of
    sorted row i. A stable sort of the keys breaks ties by original index,
    as the JAX package's (key, iota) sort does."""
    n = pos.shape[0]
    n_leaves, n_pad, _ = plan_tree(n, leaf_size, max_levels)

    with span("bh.sort"):
        lo = torch.amin(pos, dim=0)
        hi = torch.amax(pos, dim=0)
        center, half, sentinel = domain_cube(lo, hi)

        encode = hilbert_encode if curve == "hilbert" else morton_encode
        keys = encode(pos, center, half)
        if n_pad > n:
            pos_p = torch.cat([pos, sentinel.expand(n_pad - n, 3)], dim=0)
            mass_p = torch.cat([mass, mass.new_zeros(n_pad - n)], dim=0)
            keys = torch.cat([keys, keys.new_full((n_pad - n,), INT32_MAX)])
        else:
            pos_p, mass_p = pos, mass

        perm = torch.sort(keys, stable=True).indices
        pos_s = pos_p[perm]
        mass_s = mass_p[perm]
    with span("bh.tree"):
        tree = build_tree(pos_s, mass_s, leaf_size, sentinel,
                          multipole_order=multipole_order,
                          max_levels=max_levels)
    return pos_s, mass_s, perm, tree, n, n_pad


def _forces_sorted(pos_s, mass_s, tree, far_masks, rejects, *, start_leaf,
                   n_slice, leaf_size, theta, g, softening, near_budget,
                   far0_budget, compute_pot=True, refine="dense",
                   cand_budgets=(0, 0), far_mode="octet", heal=None):
    """Far+near forces for target leaves [start_leaf, start_leaf + n_slice),
    in sorted order. Returns (acc (n_slice*G, 3), pot (n_slice*G,),
    overflow).

    refine="dense": the dense leaf plane (far_masks/rejects from
    traverse(stop_level=1)); far_mode="octet" evaluates one octet-key far
    list by K2, far_mode="gather" the upper and leaf far lists of node rows
    by K4 (far0_budget then counts leaf entries). refine="staged":
    hierarchical candidate refinement (build_interaction_lists_staged;
    traverse(stop_level=2)) with cand_budgets = (cand2, cand1); one far list
    covers every far class, octet keys for K2 or node rows of _nodes_all for
    K4, and far0_budget counts its entries. The near list goes to K1 with
    its work items either way.

    heal: a ListHeal, which builds the lists at its grown budgets and
    builds them again where they clip a budget calibration chose; the
    clip count rides on the read of K1's item sizes."""
    n_leaves = pos_s.shape[0] // leaf_size
    p_leaves = pos_s.reshape(n_leaves, leaf_size, 3)
    tgt_leaves = p_leaves[start_leaf:start_leaf + n_slice]
    fkw = dict(g=g, softening=softening, compute_pot=compute_pot)

    def build(budgets, need):
        kw = dict(theta=theta, start_leaf=start_leaf, n_slice=n_slice,
                  near_budget=budgets["near"], dtype=pos_s.dtype, need=need)
        with span("bh.lists"):
            if refine == "staged":
                lists = build_interaction_lists_staged(
                    tree, far_masks, rejects, far_budget=budgets["far"],
                    cand2_budget=budgets["cand2"],
                    cand1_budget=budgets["cand1"],
                    octet_far=far_mode == "octet", **kw)
            elif far_mode == "octet":
                lists = build_interaction_lists_octet(
                    tree, far_masks, rejects, far_budget=budgets["far"],
                    **kw)
            else:
                lists = build_interaction_lists(
                    tree, far_masks, rejects, far0_budget=budgets["far"],
                    **kw)
            overflow = lists[-1]
            work = bh_kernels.near_work(lists[1], lists[0],
                                        overflow=overflow,
                                        sources=(n_leaves, leaf_size))
            return (lists, work), _clip_count(work, overflow)

    budgets = {"near": near_budget, "far": far0_budget,
               "cand2": cand_budgets[0], "cand1": cand_budgets[1]}
    lists, work = (build(budgets, {})[0] if heal is None
                   else heal.build(build, budgets, _full_widths(tree)))
    near_idx, near_valid, overflow = lists[0], lists[1], lists[-1]
    if refine == "staged" or far_mode == "octet":
        evaluate = _eval_far_octet if far_mode == "octet" else _eval_far_list
        far_idx, far_valid, nodes = lists[2:5]
        acc, pot = evaluate(tgt_leaves, nodes, far_idx, far_valid, **fkw)
    else:
        far0_idx, far0_valid, up_idx, up_valid, nodes_up, leaf_nodes = \
            lists[2:8]
        acc, pot = eval_far_lists(tgt_leaves, nodes_up, up_idx, up_valid,
                                  leaf_nodes, far0_idx, far0_valid, **fkw)
    a, ph = bh_kernels.near_field(pos_s, mass_s, tgt_leaves, near_idx,
                                  near_valid, work=work, **fkw)
    return acc + a, pot + ph, overflow


def resolve_refine(refine, cand_budgets, n_levels, near_budget, far_budget):
    """Resolve the refinement mode + staged candidate budgets (the JAX
    package's rule: "staged" needs >= 3 tree levels, auto candidate
    budgets from the list budgets with a measured cand2 floor of 256)."""
    if refine not in ("dense", "staged"):
        raise ValueError(f"refine must be dense|staged (resolved), "
                         f"got {refine!r}")
    if refine == "staged" and n_levels < 3:
        refine = "dense"
    c2, c1 = cand_budgets
    if refine == "staged":
        if c1 <= 0:
            c1 = max(128, -(-(near_budget + far_budget) // 8) + 127 & ~127)
        if c2 <= 0:
            c2 = max(256, (c1 // 4) + 63 & ~63)
    return refine, (c2, c1)


def resolve_far_mode(far_mode, refine):
    """Resolve the far-field evaluation mode. "auto" -> "octet"."""
    if far_mode not in ("auto", "octet", "gather"):
        raise ValueError(f"far_mode must be auto|octet|gather, "
                         f"got {far_mode!r}")
    return "octet" if far_mode == "auto" else far_mode


# Sections auto threshold, from the card. Peak torch.cuda.max_memory_allocated
# of Simulation(cfg) + step(1) + step(16) (tools/section_memory.py on an
# NVIDIA H100 80GB HBM3, 700.00 W, 79.2 GiB usable), in GiB:
#   N = 16M (65536 leaves):  unsectioned 2.95 / 3.33 / 4.88,
#                            4 windows   1.91 / 2.29 / 4.22;
#   N = 32M (131072 leaves): unsectioned 6.70 / 7.45 / 9.98,
#                            8 windows   3.63 / 4.38 / 8.22.
# Windows cost 3-5 % of the time of a step there and save at most 3.1 GiB,
# so the auto stays unsectioned up to the largest leaf count measured
# unsectioned (32M at leaf 256, 13 % of the card). Above it, windows of
# 65536 rows: at 64M their traversal planes (rows x level-2 nodes) are the
# size of the 32M unsectioned run's.
_SECTION_AUTO_LEAVES = 131072
_SECTION_TARGET_ROWS = 65536


def resolve_sections(sections, n_leaves, refine):
    """Resolve the evaluation section count. 0 = auto: 1 up to
    _SECTION_AUTO_LEAVES, then power-of-two windows of about
    _SECTION_TARGET_ROWS rows. Explicit counts are clamped to a power of two
    dividing n_leaves. Dense refine never sections."""
    if refine == "dense":
        return 1
    if sections <= 0:
        if n_leaves <= _SECTION_AUTO_LEAVES:
            return 1
        sections = n_leaves // _SECTION_TARGET_ROWS
    s = 1
    while s * 2 <= min(sections, n_leaves):
        s *= 2
    return s


def _windows(n_leaves, sections):
    """(start, n_slice) of each of the `sections` equal target windows."""
    w = n_leaves // sections
    return [(start, w) for start in range(0, n_leaves, w)]


def _join(parts):
    """Concatenate per-window results along rows (no copy for one)."""
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=0)


def bh_accel(pos, mass, *, leaf_size=256, theta=0.5, g=1.0, softening=1e-2,
             near_budget=64, far0_budget=2048, curve="hilbert", multipole=1,
             max_levels=12, compute_pot=True, refine="dense",
             cand_budgets=(0, 0), far_mode="auto", sections=0, heal=None):
    """Barnes-Hut accelerations/potentials in original particle order.

    Returns (acc (N,3), pot (N,), overflow ()): overflow > 0 means the
    near/far budgets clipped some entries (an upper bound on lost entries:
    staged candidate-list clips count their worst-case subtree and clipped
    far octets count 8); zero means nothing was clipped. On a CUDA device
    the list evaluations run the hand-written kernels.

    refine: "dense" (the (n_slice, n_leaves) leaf plane) or "staged"
    (hierarchical candidate refinement, build_interaction_lists_staged;
    falls back to dense on trees with fewer than 3 levels). cand_budgets =
    (cand2, cand1); 0 resolves to a default derived from the list budgets.

    sections: evaluate the target leaves in this many windows, one after
    the other, each through its own windowed traversal and lists, so that
    the traversal planes, the staged lists and their sort buffers are sized
    by n_leaves / sections. 0 = auto (resolve_sections). The physics, lists
    and overflow count are those of the unsectioned evaluation.

    heal: the caller's ListHeal. Its grown budgets replace the ones given,
    and a window whose lists clip a budget calibration chose builds them
    again at grown budgets before any force is taken from them; the
    overflow is that of the lists evaluated.
    """
    pos_s, mass_s, perm, tree, n, n_pad = _prepare(
        pos, mass, leaf_size=leaf_size, curve=curve, multipole_order=multipole,
        max_levels=max_levels)
    n_leaves = n_pad // leaf_size
    refine, cand_budgets = resolve_refine(refine, cand_budgets, tree.n_levels,
                                          near_budget, far0_budget)
    far_mode = resolve_far_mode(far_mode, refine)
    sections = resolve_sections(sections, n_leaves, refine)
    stop = 1 if refine == "dense" else 2

    accs, pots, ovfs = [], [], []
    for start, w in _windows(n_leaves, sections):
        with span("bh.traverse"):
            far_masks, rejects = traverse(tree, theta, start_leaf=start,
                                          n_slice=w, stop_level=stop)
        acc, pot, of = _forces_sorted(
            pos_s, mass_s, tree, far_masks, rejects,
            start_leaf=start, n_slice=w, leaf_size=leaf_size, theta=theta,
            g=g, softening=softening, near_budget=near_budget,
            far0_budget=far0_budget, compute_pot=compute_pot, refine=refine,
            cand_budgets=cand_budgets, far_mode=far_mode, heal=heal)
        del far_masks, rejects
        accs.append(acc)
        pots.append(pot)
        ovfs.append(of)
    acc, pot = _join(accs), _join(pots)
    overflow = torch.sum(torch.stack(ovfs), dtype=torch.int64)

    acc, pot = _unsort(acc, pot, perm, n)
    return acc, pot, overflow


def _unsort(acc, pot, perm, n):
    """Sorted-order (acc, pot) back to the caller's particle order, the
    first n rows: sorted row i belongs at original row perm[i] (perm is a
    permutation, so the scatter is exact)."""
    with span("bh.unsort"):
        acc_out = torch.empty_like(acc)
        acc_out[perm] = acc
        pot_out = torch.empty_like(pot)
        pot_out[perm] = pot
        return acc_out[:n], pot_out[:n]


def bh_accel_target_slice(pos_all, mass_all, rank, n_ranks, *, leaf_size,
                          theta, g, softening, near_budget, far0_budget,
                          curve, multipole=1, max_levels=12, refine="dense",
                          cand_budgets=(0, 0), far_mode="auto"):
    """The replicated-tree building block of the multi-device paths: forces
    for the rank-th slice of target leaves only, from the gathered global
    pos_all / mass_all (identical on every rank). Slices hold
    ceil(n_leaves / n_ranks) leaves; trailing windows are clamped into
    range and overlap the previous rank's (slice_row_of_sorted picks one
    copy). Returns (acc_slice, pot_slice, perm, overflow) in sorted order
    with the sort permutation, as the JAX package's."""
    pos_s, mass_s, perm, tree, n, n_pad = _prepare(
        pos_all, mass_all, leaf_size=leaf_size, curve=curve,
        multipole_order=multipole, max_levels=max_levels)
    n_leaves = n_pad // leaf_size
    n_slice = -(-n_leaves // n_ranks)
    start = min(rank * n_slice, n_leaves - n_slice)
    refine, cand_budgets = resolve_refine(refine, cand_budgets, tree.n_levels,
                                          near_budget, far0_budget)
    far_mode = resolve_far_mode(far_mode, refine)
    far_masks, rejects = traverse(
        tree, theta, start_leaf=start, n_slice=n_slice,
        stop_level=2 if refine == "staged" else 1)
    acc, pot, overflow = _forces_sorted(
        pos_s, mass_s, tree, far_masks, rejects, start_leaf=start,
        n_slice=n_slice, leaf_size=leaf_size, theta=theta, g=g,
        softening=softening, near_budget=near_budget,
        far0_budget=far0_budget, refine=refine, cand_budgets=cand_budgets,
        far_mode=far_mode)
    return acc, pot, perm, overflow


def slice_row_of_sorted(sorted_idx, n_leaves, n_ranks, leaf_size):
    """Row in the rank-concatenated slice results of bh_accel_target_slice
    for each sorted index: sorted leaf L is taken from rank
    min(L // n_slice, n_ranks - 1), whose window covers it."""
    n_slice = -(-n_leaves // n_ranks)
    leaf = sorted_idx // leaf_size
    rank = torch.clamp(leaf // n_slice, max=n_ranks - 1)
    start = torch.clamp(rank * n_slice, max=n_leaves - n_slice)
    return rank * (n_slice * leaf_size) + (sorted_idx - start * leaf_size)


# ------------------------------------------------------------- list reuse
class BHListPlan(NamedTuple):
    """Frozen interaction lists for rebuild-interval reuse
    (bh_rebuild_every), full width over every target leaf. overflow is the
    list-build clip counter. near_work holds K1's work items and far_order
    K2's launch order, one of each per target window of the build (None:
    built at each evaluation; an entry is None for CPU lists, which the
    plain versions evaluate without)."""

    near_idx: torch.Tensor    # (n_leaves, near_budget) source-leaf ids
    near_valid: torch.Tensor  # (n_leaves, near_budget) bool
    far_keys: torch.Tensor    # (n_leaves, far_budget) (octet_id<<8)|child_mask
    far_valid: torch.Tensor   # (n_leaves, far_budget) bool
    overflow: torch.Tensor    # () int64
    near_work: tuple | None = None
    far_order: tuple | None = None


def bh_plan_lists(tree: BHTree, *, theta, near_budget, far_budget,
                  refine, cand_budgets, dtype, leaf_size, sections=1,
                  heal=None) -> BHListPlan:
    """Traverse + build the octet-far interaction lists for ALL target
    leaves of `tree`: the geometry half of bh_accel, used by the
    rebuild-interval runs (api._make_run_reuse). refine/cand_budgets must
    arrive resolved (resolve_refine).

    sections > 1: the traversal planes and list-build temporaries are sized
    per target window exactly as in sectioned bh_accel, while the returned
    plan is full width: the list functions emit global source ids, so the
    windows' lists concatenate into the plan the unsectioned build makes.
    K1's work items and K2's launch order are built per window, here, once
    per list build.

    heal: the caller's ListHeal. Its grown budgets replace the ones given;
    where a build clips a budget calibration chose, every window is built
    again at grown budgets, from the traversal already made where there is
    one window (it does not depend on the budgets). The clip count rides
    on each window's read of K1's item sizes; the plan's overflow is that
    of the lists it holds.

    leaf_size: the tree's leaf size. One window's lists cover every leaf
    and get K1's mutual items (`bh_kernels.near_work(sources=)`), which
    evaluate each mutual leaf pair once; several windows' get the one-way
    items."""
    n_leaves = tree.com[0].shape[0]
    stop = 1 if refine == "dense" else 2
    windows = _windows(n_leaves, sections)

    def walk(start, w):
        with span("bh.traverse"):
            return traverse(tree, theta, start_leaf=start, n_slice=w,
                            stop_level=stop)

    kept = walk(*windows[0]) if len(windows) == 1 else None

    def build(budgets, need):
        kw = dict(theta=theta, near_budget=budgets["near"],
                  far_budget=budgets["far"], dtype=dtype, need=need)
        parts, works, orders, clipped = [], [], [], 0
        for start, w in windows:
            far_masks, rejects = kept if kept is not None else walk(start, w)
            with span("bh.lists"):
                if refine == "staged":
                    ni, nv, fk, fv, _, of = build_interaction_lists_staged(
                        tree, far_masks, rejects, start_leaf=start, n_slice=w,
                        cand2_budget=budgets["cand2"],
                        cand1_budget=budgets["cand1"], octet_far=True, **kw)
                else:
                    ni, nv, fk, fv, _, of = build_interaction_lists_octet(
                        tree, far_masks, rejects, start_leaf=start, n_slice=w,
                        **kw)
                del far_masks, rejects
                parts.append((ni, nv, fk, fv, of))
                works.append(bh_kernels.near_work(
                    nv, ni, overflow=of, sources=(n_leaves, leaf_size)))
                clipped += _clip_count(works[-1], of)
                orders.append(bh_kernels.far_order(fv))
        ni, nv, fk, fv, ofs = zip(*parts)
        overflow = torch.sum(torch.stack(ofs), dtype=torch.int64)
        return BHListPlan(_join(ni), _join(nv), _join(fk), _join(fv),
                          overflow, tuple(works), tuple(orders)), clipped

    budgets = {"near": near_budget, "far": far_budget,
               "cand2": cand_budgets[0], "cand1": cand_budgets[1]}
    if heal is None:
        return build(budgets, {})[0]
    return heal.build(build, budgets, _full_widths(tree))


def _refresh_nodes8(pos_s, mass_s, *, leaf_size, multipole, max_levels,
                    n_live):
    """The pyramid refresh of a frozen-list evaluation: the multipole
    pyramid of the CURRENT sorted positions as K2's 8-aligned node table
    (pads, rows [n_live:], left out of the domain cube)."""
    with span("bh.refresh"):
        lo = torch.amin(pos_s[:n_live], dim=0)
        hi = torch.amax(pos_s[:n_live], dim=0)
        _, _, sentinel = domain_cube(lo, hi)
        tree = build_tree(pos_s, mass_s, leaf_size, sentinel,
                          multipole_order=multipole, max_levels=max_levels)
        return _nodes_all_octet(tree, pos_s.dtype)


def bh_eval_lists(pos_s, mass_s, plan: BHListPlan, *, leaf_size, g,
                  softening, multipole, max_levels, compute_pot, n_live,
                  sections=1):
    """Evaluate frozen lists at CURRENT sorted positions: a fresh multipole
    pyramid + the near/far kernels; no sort, no traversal, no list build.
    Returns (acc (n_pad, 3), pot (n_pad,)) in sorted order. n_live: count
    of real rows (pads sit at rows [n_live:] and must not widen the domain
    cube). sections > 1 evaluates the target windows one after the other,
    each with the work items and launch order the plan built for it;
    physics identical to the unsectioned evaluation (whose mutual K1 items
    round differently)."""
    n_leaves = pos_s.shape[0] // leaf_size
    nodes8 = _refresh_nodes8(pos_s, mass_s, leaf_size=leaf_size,
                             multipole=multipole, max_levels=max_levels,
                             n_live=n_live)
    tgt = pos_s.reshape(n_leaves, leaf_size, 3)
    windows = _windows(n_leaves, sections)
    for built in (plan.near_work, plan.far_order):
        if built is not None and len(built) != len(windows):
            raise ValueError(f"plan built for {len(built)} windows, "
                             f"evaluated in {len(windows)}")
    kw = dict(g=g, softening=softening, compute_pot=compute_pot)
    accs, pots = [], []
    for i, (start, w) in enumerate(windows):
        rows = slice(start, start + w)
        acc, pot = _eval_far_octet(
            tgt[rows], nodes8, plan.far_keys[rows], plan.far_valid[rows],
            order=None if plan.far_order is None else plan.far_order[i], **kw)
        a, ph = bh_kernels.near_field(
            pos_s, mass_s, tgt[rows], plan.near_idx[rows],
            plan.near_valid[rows],
            work=None if plan.near_work is None else plan.near_work[i], **kw)
        accs.append(acc + a)
        pots.append(pot + ph)
    return _join(accs), _join(pots)


def leaf_aabbs(pos, mass, *, leaf_size=256, curve="hilbert"):
    """Axis-aligned bounding boxes of the occupied tree leaves, for the
    octree overlay of utils/render.py (leaves are curve-sorted groups, so
    the box is the leaf's particle AABB). Returns (lo (L, 3), hi (L, 3),
    occupied (L,) bool) on the device of pos."""
    pos_s, mass_s, _, _, _, n_pad = _prepare(pos, mass, leaf_size=leaf_size,
                                             curve=curve)
    n_leaves = n_pad // leaf_size
    p = pos_s.reshape(n_leaves, leaf_size, 3)
    occ = (mass_s.reshape(n_leaves, leaf_size) > 0)[..., None]
    lo = torch.amin(torch.where(occ, p, torch.inf), dim=1)
    hi = torch.amax(torch.where(occ, p, -torch.inf), dim=1)
    return lo, hi, torch.any(occ[..., 0], dim=1)


def _percentiles(x) -> dict:
    """p50 / p90 / p99 / max / mean of a tensor, on the host in f64 (the
    JAX package's np.percentile)."""
    import numpy as np

    x = x.detach().cpu().numpy().astype(np.float64)
    return {k: float(np.percentile(x, p)) for k, p in
            (("p50", 50), ("p90", 90), ("p99", 99), ("max", 100))} | {
                "mean": float(x.mean())}


def tree_stats(pos, mass, cfg) -> dict:
    """Structure dump for the CLI's `tree` command: depth, level widths,
    leaf-radius and interaction-list-length percentiles, overflow, for the
    refinement and far mode the config resolves to (dense octet, dense
    gather or staged), so `tree` audits what `run` executes. Staged lists
    are built in row blocks (build_interaction_lists_staged's auto), as the
    runs build them."""
    leaf = cfg.resolve_bh_leaf_size()
    pos_s, _, _, tree, n, n_pad = _prepare(
        pos, mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    n_leaves = n_pad // leaf
    near_budget = cfg.resolve_bh_near_budget()
    far_budget = cfg.resolve_bh_far_budget()
    refine, cands = resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        tree.n_levels, near_budget, far_budget)
    far_mode = resolve_far_mode(cfg.bh_far_mode, refine)
    out = {
        "n": int(n), "n_leaves": n_leaves, "leaf_size": leaf,
        "levels": tree.n_levels,
        "level_widths": [int(c.shape[0]) for c in tree.com],
        "theta": cfg.theta, "curve": cfg.bh_curve, "refine": refine,
        "far_mode": far_mode,
        "leaf_radius": _percentiles(tree.radius[0]),
        "budgets": {"near": near_budget, "far": far_budget},
    }
    kw = dict(theta=cfg.theta, start_leaf=0, n_slice=n_leaves,
              near_budget=near_budget)
    if refine == "dense" and far_mode == "octet":
        far_masks, rejects_l1 = traverse(tree, cfg.theta)
        (_, nv, _, fv, _, overflow) = build_interaction_lists_octet(
            tree, far_masks, rejects_l1, far_budget=far_budget,
            dtype=pos_s.dtype, **kw)
        out |= {
            "near_leaves_per_target": _percentiles(torch.sum(nv, dim=1)),
            "far_octets_per_target": _percentiles(torch.sum(fv, dim=1)),
            "overflow": int(overflow),
        }
    elif refine == "dense":
        far_masks, rejects_l1 = traverse(tree, cfg.theta)
        _, near_valid, _, far0_valid, overflow = leaf_interactions(
            tree, rejects_l1, far0_budget=far_budget, **kw)
        upper = sum(int(torch.sum(far_masks[k]))
                    for k in range(1, tree.n_levels))
        out |= {
            "near_leaves_per_target": _percentiles(
                torch.sum(near_valid, dim=1)),
            "far0_nodes_per_target": _percentiles(
                torch.sum(far0_valid, dim=1)),
            "upper_accepted_total": upper,
            "overflow": int(overflow),
        }
    else:  # staged
        far_masks, rej2 = traverse(tree, cfg.theta, stop_level=2)
        (_, nv, _, fv, _, overflow) = build_interaction_lists_staged(
            tree, far_masks, rej2, far_budget=far_budget,
            cand2_budget=cands[0], cand1_budget=cands[1], dtype=pos_s.dtype,
            octet_far=far_mode == "octet", **kw)
        far_key = ("far_octets_per_target" if far_mode == "octet"
                   else "far_nodes_per_target")
        out |= {
            "near_leaves_per_target": _percentiles(torch.sum(nv, dim=1)),
            far_key: _percentiles(torch.sum(fv, dim=1)),
            "l2_rejects_per_target": _percentiles(torch.sum(rej2, dim=1)),
            "cand_budgets": {"cand2": cands[0], "cand1": cands[1]},
            "overflow": int(overflow),
        }
    return out


def measure_budget_requirements(pos, mass, cfg) -> dict:
    """EXACT per-target interaction-list requirements of cfg's resolved
    Barnes-Hut pipeline on THIS mass distribution (the measurement behind
    api.calibrate_budgets): counts from the same masks/keys the list
    functions compact (_dense_leaf_masks / _refine_stage / _octet_keys_*),
    summed per target row instead of budget-clipped, so the maxima are
    exact. The staged pipeline needs candidate lists to exist before stages
    B and C can run, so it is measured in three stages: stage A (the
    traversal) yields the exact level-2 candidate maximum, which sizes stage
    B's lists exactly (no clipping by construction), whose reject maximum
    sizes stage C. Sections > 1 traverse window by window, as the runs do.

    Returns {"near_max", "far_max", "cand2_max", "cand1_max", "refine",
    "far_mode", "sections", "n_leaves", "leaf_size"} (cand maxima are 0
    for dense refine); far_max counts octet entries for the octet far mode,
    node entries for gather (dense gather: leaf entries)."""
    leaf_size = cfg.resolve_bh_leaf_size()
    theta = cfg.theta
    n = pos.shape[0]
    n_leaves, n_pad, n_levels = plan_tree(n, leaf_size, cfg.bh_max_levels)
    refine, _ = resolve_refine(cfg.resolve_bh_refine(), (1, 1), n_levels,
                               1, 1)
    far_mode = resolve_far_mode(cfg.bh_far_mode, refine)
    sections = resolve_sections(cfg.bh_sections, n_leaves, refine)
    octet = far_mode == "octet"
    out = {"refine": refine, "far_mode": far_mode, "sections": sections,
           "n_leaves": n_leaves, "leaf_size": leaf_size,
           "cand2_max": 0, "cand1_max": 0}

    _, _, _, tree, _, _ = _prepare(
        pos, mass, leaf_size=leaf_size, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    widths = [c.shape[0] for c in tree.com]
    offs8, _ = _octet_offsets(widths)
    windows = _windows(n_leaves, sections)

    if refine == "dense":
        near_max = far_max = 0
        for start, w in windows:
            far_masks, rejects_l1 = traverse(tree, theta, start_leaf=start,
                                             n_slice=w)
            near_mask, far_mask = _dense_leaf_masks(tree, rejects_l1, theta,
                                                    start, w)
            near_req = torch.sum(near_mask, dim=1)
            if octet:
                tgt_m = tree.mass[0][start:start + w]
                upk = _octet_upper_keys(far_masks, offs8, tree.n_levels,
                                        lo_level=1)
                upk = torch.where((tgt_m > 0)[:, None], upk, INT32_MAX)
                far_req = (torch.sum(_octet_keys_dense(far_mask, offs8[0])
                                     != INT32_MAX, dim=1)
                           + torch.sum(upk != INT32_MAX, dim=1))
            else:
                # Gather: only the leaf (far0) list is budgeted; the upper
                # list compacts at full width and cannot clip.
                far_req = torch.sum(far_mask, dim=1)
            near_max = max(near_max, int(torch.max(near_req)))
            far_max = max(far_max, int(torch.max(far_req)))
        return out | {"near_max": near_max, "far_max": far_max}

    # ---- staged: three exact stages (A: traverse -> cand2 requirement;
    # B: level-2 refinement at exactly-sized lists -> cand1 requirement +
    # level-1 far counts; C: level-1 refinement -> near + leaf far counts).
    offs = _level_offsets(widths)
    c2r, upc, rej2 = [], [], []
    for start, w in windows:
        far_masks, rej = traverse(tree, theta, start_leaf=start, n_slice=w,
                                  stop_level=2)
        live = (tree.mass[0][start:start + w] > 0)[:, None]
        rej2.append(rej & live)
        upk = (_octet_upper_keys(far_masks, offs8, tree.n_levels) if octet
               else _upper_keys(far_masks, offs, tree.n_levels))
        upc.append(torch.sum(torch.where(live, upk, INT32_MAX) != INT32_MAX,
                             dim=1))
        c2r.append(torch.sum(rej2[-1], dim=1))
        del far_masks, rej, upk
    rej2, upc = _join(rej2), _join(upc)
    cand2_max = int(torch.max(_join(c2r)))
    c2b = max(8, min(cand2_max, widths[2]))
    pack2, b2 = _child_pack(tree, 2)
    pack1, b1 = _child_pack(tree, 1)
    rows_all = (rej2, tree.com[0], tree.radius[0])

    def level2(args):
        """Stage B's candidates and their children (shared by B and C)."""
        rej2_b, t_com, t_r = args
        cols2 = _iota(*rej2_b.shape, rej2_b.device)
        c2_idx, c2_valid, _ = _row_compact(rej2_b, cols2, c2b)
        return c2_idx, _refine_stage(pack2, b2, c2_idx, c2_valid, t_com, t_r,
                                     theta)

    def stage_b(args):
        r = args[0].shape[0]
        c2_idx, (acc1, rej1, _) = level2(args)
        c1req = torch.sum(rej1.reshape(r, -1), dim=1)
        if octet:
            k1 = _octet_keys_children(acc1, c2_idx, offs8[1], b2)
            f1 = torch.sum(k1.reshape(r, -1) != INT32_MAX, dim=1)
        else:
            f1 = torch.sum(acc1.reshape(r, -1), dim=1)
        return c1req, f1

    c1req, f1 = _map_row_blocks(stage_b, rows_all, n_leaves,
                                _auto_row_block(c2b * b2))
    cand1_max = int(torch.max(c1req))
    c1b = max(8, min(cand1_max, widths[1]))

    def stage_c(args):
        rej2_b, t_com, t_r = args
        r = rej2_b.shape[0]
        _, (_, rej1, gid1) = level2(args)
        c1_idx, c1_valid, _ = _keys_compact(
            torch.where(rej1, gid1, INT32_MAX).reshape(r, -1), c1b)
        acc0, near0, _ = _refine_stage(pack1, b1, c1_idx, c1_valid, t_com,
                                       t_r, theta)
        near_req = torch.sum(near0.reshape(r, -1), dim=1)
        if octet:
            k0 = _octet_keys_children(acc0, c1_idx, offs8[0], b1)
            f0 = torch.sum(k0.reshape(r, -1) != INT32_MAX, dim=1)
        else:
            f0 = torch.sum(acc0.reshape(r, -1), dim=1)
        return near_req, f0

    near_req, f0 = _map_row_blocks(stage_c, rows_all, n_leaves,
                                   _auto_row_block(max(c1b * b1, c2b * b2)))
    return out | {"near_max": int(torch.max(near_req)),
                  "far_max": int(torch.max(upc + f1 + f0)),
                  "cand2_max": cand2_max, "cand1_max": cand1_max}


def measure_import_requirement(pos, mass, cfg, n_ranks: int) -> dict:
    """The LET import-budget requirement (bh_comm="let") on this mass
    distribution: over (requester, owner) rank pairs, the largest count of
    distinct owner leaves that the requester's near lists reference. It
    sizes the per-pair import capacity cap_req of the LET plan
    (parallel/distributed.py); api.calibrate_budgets(n_ranks=...) derives
    bh_import_budget from it. The ranks' key ranges are approximated by
    equal-count contiguous leaf windows of the single-device curve order
    (the JAX package's proxy); every import the budget clips is still
    counted into the run's overflow. Returns {"import_max",
    "n_leaf_loc_proxy", "n_leaves"}."""
    import numpy as np

    leaf_size = cfg.resolve_bh_leaf_size()
    n_leaves, _, n_levels = plan_tree(pos.shape[0], leaf_size,
                                      cfg.bh_max_levels)
    refine, cands = resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        n_levels, cfg.resolve_bh_near_budget(), cfg.resolve_bh_far_budget())
    sections = resolve_sections(cfg.bh_sections, n_leaves, refine)
    _, _, _, tree, _, _ = _prepare(
        pos, mass, leaf_size=leaf_size, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    plan = bh_plan_lists(
        tree, theta=cfg.theta, near_budget=cfg.resolve_bh_near_budget(),
        far_budget=cfg.resolve_bh_far_budget(), refine=refine,
        cand_budgets=cands, dtype=pos.dtype, leaf_size=leaf_size,
        sections=sections)
    ni = plan.near_idx.cpu().numpy()
    nv = plan.near_valid.cpu().numpy()
    l_loc = -(-n_leaves // n_ranks)
    owner = np.minimum(np.arange(n_leaves) // l_loc, n_ranks - 1)
    imp_max = 0
    for r in range(n_ranks):
        rows = slice(r * l_loc, min((r + 1) * l_loc, n_leaves))
        ids = np.unique(ni[rows][nv[rows]])
        counts = np.bincount(owner[ids], minlength=n_ranks)
        counts[r] = 0
        imp_max = max(imp_max, int(counts.max()))
    return {"import_max": imp_max, "n_leaf_loc_proxy": l_loc,
            "n_leaves": n_leaves}


def make_bh_accel(cfg, mass, overflow_cell=None, heal=None):
    """accel_fn(pos) -> (acc, pot) with the configured BH parameters.

    overflow_cell: optional one-element list; each evaluation's budget
    overflow counter (a device tensor, no host sync) is ACCUMULATED into it,
    so multi-eval integrators sum clipping over their evaluations.

    heal: the caller's ListHeal (bh_accel's heal), kept across the
    evaluations of every accel_fn it is given to."""

    def accel_fn(pos):
        with span("force"):
            acc, pot, ovf = bh_accel(
                pos, mass,
                leaf_size=cfg.resolve_bh_leaf_size(), theta=cfg.theta,
                g=cfg.g, softening=cfg.softening,
                near_budget=cfg.resolve_bh_near_budget(),
                far0_budget=cfg.resolve_bh_far_budget(), curve=cfg.bh_curve,
                multipole=cfg.bh_multipole, max_levels=cfg.bh_max_levels,
                compute_pot=cfg.track_potential,
                refine=cfg.resolve_bh_refine(),
                cand_budgets=(cfg.bh_cand2_budget, cfg.bh_cand_budget),
                far_mode=cfg.bh_far_mode, sections=cfg.bh_sections,
                heal=heal,
            )
            if overflow_cell is not None:
                overflow_cell[0] = overflow_cell[0] + ovf
            return acc, pot

    return accel_fn
