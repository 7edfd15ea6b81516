"""Barnes-Hut gravity: Hilbert sort + multipole pyramid + level-synchronous
masked traversal + per-target interaction lists, in torch.

Counterpart of `parallelnbody_tpu/ops/bh.py`, ported for dense refinement
(the auto below 8192 leaves) with either far field:

  1. Hilbert-sort particles (ops/hilbert.py; Morton optional); the sorted
     order is the octree linearization.
  2. Group particles into fixed-size leaves and build a multipole pyramid
     (mass, CoM, bounding radius, traceless quadrupole) by reshape-reductions.
  3. Level-synchronous traversal with dense boolean masks over the upper
     levels; the group MAC accepts a node or expands its children.
  4. The dense (n_slice, n_leaves) leaf plane splits candidate leaves into
     exact near pairs and far multipoles. far_mode="octet" (the auto) keys
     every far node as (octet_id << 8) | child_mask over the 8-aligned node
     table; far_mode="gather" keeps two lists of node rows, the accepted
     upper nodes and the accepted leaves.
  5. The lists go to the hand-written kernels (ops/bh_kernels.py): K1 the
     near field, K2 the octet far field, K4 the gather far lists. List
     budget overflow is reported, never silently dropped.

Integer outputs (keys, sort order, masks, lists, overflow) equal the JAX
package's on the same inputs; `INT32_MAX` stays the empty-entry sentinel.
Staged refinement and sections > 1 are not ported yet and raise
NotImplementedError (ROADMAP).

The acceptance criterion is the conservative group MAC
    MAC_SIZE_SCALE * r_node < theta * (d - r_leaf)
with r_* tight bounding radii around each group's center of mass.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from parallelnbody_tpu_torch.ops import bh_kernels
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode
from parallelnbody_tpu_torch.ops.morton import morton_encode

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


def _keys_compact(keys, budget):
    """Front-pack the finite (!= INT32_MAX) int32 keys of each row into a
    padded ascending (n_rows, budget) list by one row sort. Returns
    (idx, valid, overflow)."""
    n_rows, n_cols = keys.shape
    budget = min(budget, n_cols)
    counts = torch.sum(keys != INT32_MAX, dim=1, dtype=torch.int32)
    overflow = torch.sum(torch.clamp(counts - budget, min=0),
                         dtype=torch.int32)
    idx = torch.sort(keys, dim=1).values[:, :budget]
    valid = _iota(n_rows, budget, keys.device) < counts[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid, overflow


def _row_compact(mask, fill_idx, budget):
    """Front-pack the True column-values of `fill_idx` per row into a padded
    (n_rows, budget) list. Returns (idx, valid, overflow); ascending when
    fill_idx rows are."""
    return _keys_compact(
        torch.where(mask, fill_idx, torch.full_like(fill_idx, INT32_MAX)),
        budget)


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
                      far0_budget: int):
    """Refine rejected level-1 nodes to leaf granularity for the target-leaf
    slice [start_leaf, start_leaf + n_slice) through the dense leaf plane:
    front-packed lists of exact near leaves and of accepted leaf monopoles
    (far0). Returns (near_idx, near_valid, far0_idx, far0_valid,
    overflow)."""
    near_mask, far_mask = _dense_leaf_masks(tree, rejects_l1, theta,
                                            start_leaf, n_slice)
    cols = _iota(n_slice, tree.com[0].shape[0], near_mask.device)
    near_idx, near_valid, of_n = _row_compact(near_mask, cols, near_budget)
    far0_idx, far0_valid, of_f = _row_compact(far_mask, cols, far0_budget)
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
                                  far_budget, dtype):
    """Dense-refinement lists in octet-masked far form: ONE far list of
    (octet_id << 8) | child_mask keys covering every far class (upper
    accepted nodes, levels >= 1, and leaf-MAC-accepted candidates) over the
    8-aligned combined node table, plus the near list of source leaves.
    far_budget counts octet entries.

    Returns (near_idx, near_valid, far_keys, far_valid, nodes8, overflow);
    overflow counts near clips plus 8x clipped far octets."""
    near_mask, far_mask = _dense_leaf_masks(tree, rejects_l1, theta,
                                            start_leaf, n_slice)
    n_leaves = tree.com[0].shape[0]
    offs8, n_oct = _octet_offsets([c.shape[0] for c in tree.com])

    cols = _iota(n_slice, n_leaves, near_mask.device)
    near_idx, near_valid, of_n = _row_compact(near_mask, cols, near_budget)

    # Phantom (zero-mass) targets: the leaf masks already exclude them; the
    # upper masks are blanked the same way.
    tgt_m = tree.mass[0][start_leaf:start_leaf + n_slice]
    upk = _octet_upper_keys(far_masks, offs8, tree.n_levels, lo_level=1)
    upk = torch.where((tgt_m > 0)[:, None], upk,
                      torch.full_like(upk, INT32_MAX))
    far_keys = torch.cat([_octet_keys_dense(far_mask, offs8[0]), upk], dim=1)
    far_keys, far_valid, of_f = _keys_compact(far_keys,
                                              min(far_budget, n_oct))
    overflow = (of_n + 8 * of_f).to(torch.int32)
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


# ------------------------------------------------------ gather far lists
def build_interaction_lists(tree, far_masks, rejects_l1, *, theta, start_leaf,
                            n_slice, near_budget, far0_budget, dtype):
    """Dense-refinement lists in gather form for one target window: the near
    list, the far0 list of accepted leaves over the leaf node table, and
    the list of accepted upper nodes (levels >= 1) over their stacked node
    table. The upper acceptance mask is narrow, so it is compacted at full
    width and cannot clip; far0_budget counts leaf entries.

    Returns (near_idx, near_valid, far0_idx, far0_valid, up_idx, up_valid,
    nodes_up, leaf_nodes, overflow)."""
    near_idx, near_valid, far0_idx, far0_valid, overflow = leaf_interactions(
        tree, rejects_l1, theta, start_leaf=start_leaf, n_slice=n_slice,
        near_budget=near_budget, far0_budget=far0_budget)
    nodes_up = torch.cat(
        [_node_table(tree, k, dtype) for k in range(1, tree.n_levels)], dim=0)
    up_mask = torch.cat([far_masks[k] for k in range(1, tree.n_levels)],
                        dim=1)
    cols_up = _iota(*up_mask.shape, up_mask.device)
    up_idx, up_valid, _ = _row_compact(up_mask, cols_up, nodes_up.shape[0])
    return (near_idx, near_valid, far0_idx, far0_valid, up_idx, up_valid,
            nodes_up, _node_table(tree, 0, dtype), overflow)


def eval_far_lists(tgt_leaves, nodes_up, up_idx, up_valid, leaf_nodes,
                   far0_idx, far0_valid, *, g, softening, compute_pot=True):
    """Both gather far classes for one target window, each a front-packed
    list of node rows evaluated by K4 (the JAX package's `_eval_far_list`),
    summed in the JAX package's order: the upper nodes, then the accepted
    leaves."""
    kw = dict(g=g, softening=softening, compute_pot=compute_pot)
    acc, pot = bh_kernels.far_gather(tgt_leaves, nodes_up, up_idx, up_valid,
                                     **kw)
    a, ph = bh_kernels.far_gather(tgt_leaves, leaf_nodes, far0_idx,
                                  far0_valid, **kw)
    return acc + a, pot + ph


# ------------------------------------------------------------------- assembly
def _prepare(pos, mass, *, leaf_size, curve, multipole_order=1, max_levels=12):
    """Pad, curve-sort, and build the multipole pyramid. Returns
    (pos_s, mass_s, perm, tree, n, n_pad); perm[i] is the original row of
    sorted row i. A stable sort of the keys breaks ties by original index,
    as the JAX package's (key, iota) sort does."""
    n = pos.shape[0]
    n_leaves, n_pad, _ = plan_tree(n, leaf_size, max_levels)

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
    tree = build_tree(pos_s, mass_s, leaf_size, sentinel,
                      multipole_order=multipole_order, max_levels=max_levels)
    return pos_s, mass_s, perm, tree, n, n_pad


def _require_ported(refine, far_mode, sections):
    """Raise for the configurations outside the ported slice: dense
    refinement with either far mode and one section is ported."""
    if refine == "staged":
        raise NotImplementedError(
            f"bh_refine='staged' (auto from 8192 leaves; here with "
            f"bh_far_mode={far_mode!r}) is not ported yet (ROADMAP Queue 1: "
            "staged refinement)")
    if sections != 1:
        raise NotImplementedError(
            f"bh_sections={sections} is not ported yet (ROADMAP Queue 1: "
            "sections)")


def _forces_sorted(pos_s, mass_s, tree, far_masks, rejects, *, start_leaf,
                   n_slice, leaf_size, theta, g, softening, near_budget,
                   far0_budget, compute_pot=True, refine="dense",
                   far_mode="octet"):
    """Far+near forces for target leaves [start_leaf, start_leaf + n_slice),
    in sorted order, from the dense leaf plane: far_mode="octet" evaluates
    one octet-key far list by K2, far_mode="gather" the upper and leaf
    far lists of node rows by K4 (far0_budget then counts leaf entries);
    the near list goes to K1 either way. Returns
    (acc (n_slice*G, 3), pot (n_slice*G,), overflow)."""
    _require_ported(refine, far_mode, 1)
    n_leaves = pos_s.shape[0] // leaf_size
    p_leaves = pos_s.reshape(n_leaves, leaf_size, 3)
    tgt_leaves = p_leaves[start_leaf:start_leaf + n_slice]
    kw = dict(theta=theta, start_leaf=start_leaf, n_slice=n_slice,
              near_budget=near_budget, dtype=pos_s.dtype)
    if far_mode == "octet":
        (near_idx, near_valid, far_keys, far_valid, nodes8,
         overflow) = build_interaction_lists_octet(
            tree, far_masks, rejects, far_budget=far0_budget, **kw)
        work = bh_kernels.near_work(near_valid)
        acc, pot = _eval_far_octet(tgt_leaves, nodes8, far_keys, far_valid,
                                   g=g, softening=softening,
                                   compute_pot=compute_pot)
    else:
        (near_idx, near_valid, far0_idx, far0_valid, up_idx, up_valid,
         nodes_up, leaf_nodes, overflow) = build_interaction_lists(
            tree, far_masks, rejects, far0_budget=far0_budget, **kw)
        work = bh_kernels.near_work(near_valid)
        acc, pot = eval_far_lists(tgt_leaves, nodes_up, up_idx, up_valid,
                                  leaf_nodes, far0_idx, far0_valid, g=g,
                                  softening=softening,
                                  compute_pot=compute_pot)
    a, ph = bh_kernels.near_field(pos_s, mass_s, tgt_leaves, near_idx,
                                  near_valid, g=g, softening=softening,
                                  compute_pot=compute_pot, work=work)
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


# Sections auto threshold of the JAX package (a TPU v5e memory boundary);
# kept so both packages resolve a config alike until the port measures its
# own on the GPU.
_SECTION_AUTO_LEAVES = 65536
_SECTION_TARGET_ROWS = 16384


def resolve_sections(sections, n_leaves, refine):
    """Resolve the evaluation section count. 0 = auto: 1 up to
    _SECTION_AUTO_LEAVES, then power-of-two windows of ~16384 rows.
    Explicit counts are clamped to a power of two dividing n_leaves. Dense
    refine never sections."""
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


def bh_accel(pos, mass, *, leaf_size=256, theta=0.5, g=1.0, softening=1e-2,
             near_budget=64, far0_budget=2048, curve="hilbert", multipole=1,
             max_levels=12, compute_pot=True, refine="dense",
             cand_budgets=(0, 0), far_mode="auto", sections=0):
    """Barnes-Hut accelerations/potentials in original particle order.

    Returns (acc (N,3), pot (N,), overflow ()): overflow > 0 means the
    near/far budgets clipped some entries (an upper bound on lost entries:
    clipped far octets count 8); zero means nothing was clipped. On a CUDA
    device the two list evaluations run the hand-written kernels.
    """
    pos_s, mass_s, perm, tree, n, n_pad = _prepare(
        pos, mass, leaf_size=leaf_size, curve=curve, multipole_order=multipole,
        max_levels=max_levels)
    n_leaves = n_pad // leaf_size
    refine, cand_budgets = resolve_refine(refine, cand_budgets, tree.n_levels,
                                          near_budget, far0_budget)
    far_mode = resolve_far_mode(far_mode, refine)
    _require_ported(refine, far_mode,
                    resolve_sections(sections, n_leaves, refine))

    far_masks, rejects = traverse(tree, theta, stop_level=1)
    acc, pot, overflow = _forces_sorted(
        pos_s, mass_s, tree, far_masks, rejects,
        start_leaf=0, n_slice=n_leaves, leaf_size=leaf_size, theta=theta,
        g=g, softening=softening, near_budget=near_budget,
        far0_budget=far0_budget, compute_pot=compute_pot, refine=refine,
        far_mode=far_mode)

    # Unsort back to the caller's particle order: sorted row i belongs at
    # original row perm[i] (perm is a permutation, so the scatter is exact).
    acc_out = torch.empty_like(acc)
    acc_out[perm] = acc
    pot_out = torch.empty_like(pot)
    pot_out[perm] = pot
    return acc_out[:n], pot_out[:n], overflow


# ------------------------------------------------------------- list reuse
class BHListPlan(NamedTuple):
    """Frozen interaction lists for rebuild-interval reuse
    (bh_rebuild_every). overflow is the list-build clip counter; near_work
    holds K1's work items for the near lists and far_order K2's launch
    order for the far lists (None: built at each evaluation, or not needed
    on the CPU)."""

    near_idx: torch.Tensor    # (n_leaves, near_budget) source-leaf ids
    near_valid: torch.Tensor  # (n_leaves, near_budget) bool
    far_keys: torch.Tensor    # (n_leaves, far_budget) (octet_id<<8)|child_mask
    far_valid: torch.Tensor   # (n_leaves, far_budget) bool
    overflow: torch.Tensor    # () int32
    near_work: bh_kernels.NearWork | None = None
    far_order: torch.Tensor | None = None


def bh_plan_lists(tree: BHTree, *, theta, near_budget, far_budget,
                  refine, cand_budgets, dtype, sections=1) -> BHListPlan:
    """Traverse + build the octet-far interaction lists for ALL target
    leaves of `tree`: the geometry half of bh_accel, used by the
    rebuild-interval runs (api._make_run_reuse). refine/cand_budgets must
    arrive resolved (resolve_refine)."""
    _require_ported(refine, "octet", sections)
    n_leaves = tree.com[0].shape[0]
    far_masks, rejects = traverse(tree, theta, stop_level=1)
    ni, nv, fk, fv, _, of = build_interaction_lists_octet(
        tree, far_masks, rejects, theta=theta, start_leaf=0,
        n_slice=n_leaves, near_budget=near_budget, far_budget=far_budget,
        dtype=dtype)
    return BHListPlan(ni, nv, fk, fv, of.to(torch.int32),
                      bh_kernels.near_work(nv), bh_kernels.far_order(fv))


def bh_eval_lists(pos_s, mass_s, plan: BHListPlan, *, leaf_size, g,
                  softening, multipole, max_levels, compute_pot, n_live,
                  sections=1):
    """Evaluate frozen lists at CURRENT sorted positions: a fresh multipole
    pyramid + the near/far kernels; no sort, no traversal, no list build.
    Returns (acc (n_pad, 3), pot (n_pad,)) in sorted order. n_live: count
    of real rows (pads sit at rows [n_live:] and must not widen the domain
    cube)."""
    _require_ported("dense", "octet", sections)
    dtype = pos_s.dtype
    n_pad = pos_s.shape[0]
    n_leaves = n_pad // leaf_size
    lo = torch.amin(pos_s[:n_live], dim=0)
    hi = torch.amax(pos_s[:n_live], dim=0)
    _, _, sentinel = domain_cube(lo, hi)
    tree = build_tree(pos_s, mass_s, leaf_size, sentinel,
                      multipole_order=multipole, max_levels=max_levels)
    nodes8 = _nodes_all_octet(tree, dtype)
    tgt = pos_s.reshape(n_leaves, leaf_size, 3)
    acc, pot = _eval_far_octet(tgt, nodes8, plan.far_keys, plan.far_valid,
                               g=g, softening=softening,
                               compute_pot=compute_pot, order=plan.far_order)
    a, ph = bh_kernels.near_field(pos_s, mass_s, tgt, plan.near_idx,
                                  plan.near_valid, g=g, softening=softening,
                                  compute_pot=compute_pot, work=plan.near_work)
    return acc + a, pot + ph


def measure_budget_requirements(pos, mass, cfg) -> dict:
    """EXACT per-target interaction-list requirements of cfg's resolved
    Barnes-Hut pipeline on THIS mass distribution (the measurement behind
    api.calibrate_budgets): counts from the same masks/keys the list
    builders compact, summed per target row instead of budget-clipped.

    Returns {"near_max", "far_max", "cand2_max", "cand1_max", "refine",
    "far_mode", "sections", "n_leaves", "leaf_size"}; far_max counts octet
    entries for the octet far mode and leaf entries for gather. Dense
    refinement only (staged is not ported yet)."""
    leaf_size = cfg.resolve_bh_leaf_size()
    theta = cfg.theta
    n = pos.shape[0]
    n_leaves, n_pad, n_levels = plan_tree(n, leaf_size, cfg.bh_max_levels)
    refine, _ = resolve_refine(cfg.resolve_bh_refine(), (1, 1), n_levels,
                               1, 1)
    far_mode = resolve_far_mode(cfg.bh_far_mode, refine)
    sections = resolve_sections(cfg.bh_sections, n_leaves, refine)
    _require_ported(refine, far_mode, sections)
    out = {"refine": refine, "far_mode": far_mode, "sections": sections,
           "n_leaves": n_leaves, "leaf_size": leaf_size,
           "cand2_max": 0, "cand1_max": 0}

    _, _, _, tree, _, _ = _prepare(
        pos, mass, leaf_size=leaf_size, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    far_masks, rejects_l1 = traverse(tree, theta)
    near_mask, far_mask = _dense_leaf_masks(tree, rejects_l1, theta, 0,
                                            n_leaves)
    near_req = torch.sum(near_mask, dim=1)
    if far_mode == "octet":
        offs8, _ = _octet_offsets([c.shape[0] for c in tree.com])
        upk = _octet_upper_keys(far_masks, offs8, tree.n_levels, lo_level=1)
        upk = torch.where((tree.mass[0] > 0)[:, None], upk,
                          torch.full_like(upk, INT32_MAX))
        far_req = (torch.sum(_octet_keys_dense(far_mask, offs8[0])
                             != INT32_MAX, dim=1)
                   + torch.sum(upk != INT32_MAX, dim=1))
    else:
        # Gather: only the leaf (far0) list is budgeted; the upper list
        # compacts at full width and cannot clip.
        far_req = torch.sum(far_mask, dim=1)
    return out | {"near_max": int(torch.max(near_req)),
                  "far_max": int(torch.max(far_req))}


def make_bh_accel(cfg, mass, overflow_cell=None):
    """accel_fn(pos) -> (acc, pot) with the configured BH parameters.

    overflow_cell: optional one-element list; each evaluation's budget
    overflow counter (a device tensor, no host sync) is ACCUMULATED into it,
    so multi-eval integrators sum clipping over their evaluations."""

    def accel_fn(pos):
        acc, pot, ovf = bh_accel(
            pos, mass,
            leaf_size=cfg.resolve_bh_leaf_size(), theta=cfg.theta, g=cfg.g,
            softening=cfg.softening, near_budget=cfg.resolve_bh_near_budget(),
            far0_budget=cfg.resolve_bh_far_budget(), curve=cfg.bh_curve,
            multipole=cfg.bh_multipole, max_levels=cfg.bh_max_levels,
            compute_pot=cfg.track_potential,
            refine=cfg.resolve_bh_refine(),
            cand_budgets=(cfg.bh_cand2_budget, cfg.bh_cand_budget),
            far_mode=cfg.bh_far_mode, sections=cfg.bh_sections,
        )
        if overflow_cell is not None:
            overflow_cell[0] = overflow_cell[0] + ovf.to(torch.int32)
        return acc, pot

    return accel_fn
