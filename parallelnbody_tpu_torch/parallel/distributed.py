"""Distributed-sort Barnes-Hut. Counterpart of
`parallelnbody_tpu/parallel/distributed.py`.

The replicated-tree path (parallel/sharded.py) gathers every particle on
every rank. Here each rank keeps O(N/P) particles:

  1. Sample-sort repartition. Each rank encodes its live particles against
     the global bounding cube (all_reduce max), contributes
     SAMPLES_PER_RANK key quantiles; the gathered sample gives P - 1
     splitters, the same on every rank. Migrants move with one all_to_all
     at a static per-pair capacity; stayers never move. The merge sorts by
     (key, global id), so ties break as the single-device stable sort does.
  2. Local trees, replicated top: each rank's leaf summaries (~40 B a
     leaf) are gathered and every rank builds the upper pyramid.
  3. Traversal and lists for the rank's own target leaves (ops/bh.py).
  4. Near field, ring or LET. bh_comm="ring": the owned particle tiles
     rotate around the ring and pass p evaluates the visiting shard's
     window of global leaf ids with K1's window form, P launches an
     evaluation. bh_comm="let": each rank imports only the leaf tiles its
     lists name, with one request and one response all_to_all, and runs
     K1's table form once. With bh_import_budget 0 the table holds the
     whole global leaf table (O(N) a rank); api.calibrate_budgets(n_ranks=P)
     measures a budget that restores O(halo).
  5. Reverse exchange: (acc, pot) go back to each particle's origin rank.

Static capacities: the per-pair exchange capacity, the owned capacity, the
list budgets and the LET import capacity keep the JAX package's values and
sizes, so that overflow counts compare; every clipped particle, list entry
or import is counted into the returned overflow, never dropped silently.
Torch has no "drop" scatter mode: scatters write one spare slot past the
end for dropped rows, and the spare slot is cut off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from parallelnbody_tpu_torch.ops import bh_kernels
from parallelnbody_tpu_torch.ops.bh import (
    INT32_MAX, BHSetup, _far_forces, _nodes_all_octet, _window_lists,
    domain_cube, leaf_rows, traverse, tree_of_rows)
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode
from parallelnbody_tpu_torch.ops.morton import morton_encode
from parallelnbody_tpu_torch.parallel.mesh import RingGroup

SAMPLES_PER_RANK = 64   # splitter sample quantiles per rank


def _plan(n_local: int, n_ranks: int, leaf_size: int,
          pair_slack: float = 2.0, own_slack: float = 0.25):
    """Static capacities (cap_pair, own_cap, n_leaf_loc), the JAX
    package's: cap_pair is raised where needed so that the merged buffer
    (n_local stay slots + P * cap_pair arrivals) can fill own_cap."""
    cap_pair = max(8, int(pair_slack * n_local / max(n_ranks, 1) + 7) // 8 * 8)
    own_cap = -(-int(n_local * (1 + own_slack)) // leaf_size) * leaf_size
    need = -(-(own_cap - n_local) // max(n_ranks, 1))
    cap_pair = max(cap_pair, (need + 7) // 8 * 8)
    return cap_pair, own_cap, own_cap // leaf_size


def _plan_cfg(cfg, n_local: int, n_ranks: int, leaf_size: int):
    return _plan(n_local, n_ranks, leaf_size,
                 pair_slack=cfg.bh_pair_slack, own_slack=cfg.bh_own_slack)


def _scatter(n, slot, values, fill, dtype):
    """(n,) + trailing dims of `values`, `fill` everywhere but at `slot`,
    which receives `values`; slot == n drops the row (the spare slot)."""
    out = torch.full((n + 1,) + tuple(values.shape[1:]), fill, dtype=dtype,
                     device=values.device)
    out[slot] = values.to(dtype)
    return out[:n]


def _exchange(dest, ok_migrant, cols_f, cols_i, fills_i, group: RingGroup,
              cap_pair):
    """Send each migrant row to rank `dest` at a static per-pair capacity.
    cols_f: float (n,) columns (empty slots read 0); cols_i: int32 (n,)
    columns with the empty-slot fills fills_i. One all_to_all for the
    float columns and one for the int columns. Returns (recv_f, recv_i,
    n_clipped), columns of n_ranks * cap_pair rows."""
    n_ranks = group.world_size
    onehot = ((dest[:, None] == torch.arange(n_ranks, device=dest.device))
              & ok_migrant[:, None]).to(torch.int64)
    within = torch.sum((torch.cumsum(onehot, 0) - 1) * onehot, 1)
    sendable = ok_migrant & (within < cap_pair)
    n_clipped = torch.sum(ok_migrant & (within >= cap_pair),
                          dtype=torch.int32)
    n_buf = n_ranks * cap_pair
    slot = torch.where(sendable, dest.to(torch.int64) * cap_pair + within,
                       n_buf)
    fdt = cols_f[0].dtype
    recv_f = group.all_to_all(_scatter(
        n_buf, slot, torch.stack(cols_f, 1), 0.0, fdt)).unbind(1)
    buf_i = torch.tensor(fills_i, dtype=torch.int32, device=dest.device
                         ).repeat(n_buf + 1, 1)
    buf_i[slot] = torch.stack(cols_i, 1).to(torch.int32)
    recv_i = group.all_to_all(buf_i[:n_buf]).unbind(1)
    return list(recv_f), list(recv_i), n_clipped


def _repartition(pos, extras, mass, ids, valid_in, *, group: RingGroup,
                 cap_pair, own_cap, n_live, curve):
    """Key-repartition the live rows so that each rank owns a contiguous
    curve range, carrying `extras` (float columns) through the exchange and
    the (key, id) merge. Invalid rows are dropped; the owned arrays are
    padded with zero-mass rows at this rank's sentinel (offset by rank *
    half along x, so that the pad clusters of different ranks do not
    coincide). n_live is the static live count per rank (N/P) bounding the
    sample size. Returns (pos_own, extras_own, mass_own, id_own, valid_own,
    sentinel, overflow, n_migrants)."""
    dtype = pos.dtype
    n_ranks, rank = group.world_size, group.rank
    big = torch.tensor(torch.inf, dtype=dtype, device=pos.device)
    lo = torch.amin(torch.where(valid_in[:, None], pos, big), 0)
    hi = torch.amax(torch.where(valid_in[:, None], pos, -big), 0)
    bounds = group.all_reduce(torch.cat([-lo, hi]), op="max")
    center, half, sentinel = domain_cube(-bounds[:3], bounds[3:])
    sentinel = sentinel + (rank * half) * torch.tensor(
        [1.0, 0.0, 0.0], dtype=dtype, device=pos.device)
    encode = hilbert_encode if curve == "hilbert" else morton_encode
    keys = torch.where(valid_in, encode(pos, center, half),
                       torch.full_like(ids, INT32_MAX))

    # Splitters: sample quantiles over this rank's live count.
    s = min(SAMPLES_PER_RANK, n_live)
    k_sorted = torch.sort(keys).values
    cnt = torch.sum(valid_in)
    qpos = (torch.arange(s, device=pos.device) * cnt) // s + cnt // (2 * s)
    samp = k_sorted[torch.clamp(qpos, min=0)
                    .minimum(torch.clamp(cnt - 1, min=0))]
    all_samp = torch.sort(group.all_gather(samp)).values
    if n_ranks > 1:
        spl = all_samp[(torch.arange(1, n_ranks, device=pos.device)
                        * n_ranks * s) // n_ranks]
        dest = torch.sum(keys[:, None] >= spl[None, :], 1)
    else:
        dest = torch.zeros_like(keys, dtype=torch.int64)
    dest = torch.where(valid_in, dest, n_ranks)   # pads never move nor stay
    stay = valid_in & (dest == rank)

    cols_f = [pos[:, 0], pos[:, 1], pos[:, 2]] + list(extras) + [mass]
    recv_f, (fkey, fid), of_pair = _exchange(
        dest, valid_in & ~stay, cols_f, [keys, ids], [INT32_MAX, -1], group,
        cap_pair)

    # Merge stayers and arrivals, sorted by (key, id): one int64 key with
    # the id shifted to non-negative in the low 32 bits.
    m_key = torch.cat([torch.where(stay, keys, INT32_MAX), fkey]).long()
    m_id = torch.cat([ids.to(torch.int32), fid]).long()
    order = torch.sort((m_key << 32) | (m_id + 2**31), stable=True).indices
    sk = m_key[order]
    sid = m_id[order][:own_cap].to(torch.int32)
    m_cols = [torch.cat([torch.where(stay, c, torch.zeros_like(c)), r])[order]
              for c, r in zip(cols_f, recv_f)]
    valid_own = sk[:own_cap] != INT32_MAX
    of_own = torch.sum(sk[own_cap:] != INT32_MAX, dtype=torch.int32)
    sc = [c[:own_cap] for c in m_cols]
    pos_own = torch.where(valid_own[:, None], torch.stack(sc[0:3], 1),
                          sentinel[None, :])
    extras_own = [torch.where(valid_own, c, torch.zeros_like(c))
                  for c in sc[3:-1]]
    mass_own = torch.where(valid_own, sc[-1], torch.zeros_like(sc[-1]))
    # Invalid rows carry id -1: the persistent run takes pids >= 0 as live.
    sid = torch.where(valid_own, sid, -1)
    n_migrants = torch.sum(valid_in & ~stay, dtype=torch.int32)
    return (pos_own, extras_own, mass_own, sid, valid_own, sentinel,
            of_pair + of_own, n_migrants)


# ------------------------------------------------------------------- LET
class _LetPlan(NamedTuple):
    """Frozen LET import map (list geometry, reusable across a rebuild
    interval): the request vector each owner received (req_in), the dense
    table slots of imported (tpos) and own (own_slot) tiles, the near lists
    remapped onto dense slots (new_idx), the clipped-import count and K1's
    work items for the table form (None on the CPU)."""

    req_in: torch.Tensor    # (P*cap_req,) global leaf ids to serve
    tpos: torch.Tensor      # (P*cap_req,) dense slot of each response row
    own_slot: torch.Tensor  # (n_leaf_loc,) dense slot of each own tile
    new_idx: torch.Tensor   # near lists remapped onto dense slots
    overflow: torch.Tensor  # () int32
    work: object = None


def _let_caps(cfg, n_ranks, n_leaf_loc):
    cap_req = min(cfg.bh_import_budget or n_leaf_loc, n_leaf_loc)
    return cap_req, n_leaf_loc + (n_ranks - 1) * cap_req


def _near_let_plan(near_idx, near_valid, cfg, *, group: RingGroup,
                   n_leaf_loc) -> _LetPlan:
    """The locally essential import map from the near lists: a cumsum over
    the global leaf-id axis numbers the needed leaves densely (monotone, so
    the remapped lists stay ascending and front-packed); per-owner request
    slots are a row cumsum (rank r owns [r*n_leaf_loc, (r+1)*n_leaf_loc)).
    The request all_to_all runs here, once per plan."""
    n_ranks, rank = group.world_size, group.rank
    dev = near_idx.device
    l_glob = n_ranks * n_leaf_loc
    cap_req, cap_table = _let_caps(cfg, n_ranks, n_leaf_loc)
    start = rank * n_leaf_loc

    flat = torch.where(near_valid, near_idx, l_glob).reshape(-1).long()
    needed = torch.zeros((l_glob + 1,), dtype=torch.bool, device=dev)
    needed[flat] = True
    needed = needed[:l_glob]
    needed_pos = torch.cumsum(needed.to(torch.int32), 0, dtype=torch.int32) - 1
    n_needed = torch.sum(needed, dtype=torch.int32)

    own_block = torch.arange(n_ranks, device=dev) == rank
    mask_r = needed.reshape(n_ranks, n_leaf_loc) & ~own_block[:, None]
    within = torch.cumsum(mask_r.to(torch.int32), 1, dtype=torch.int32) - 1
    counts = torch.sum(mask_r, 1, dtype=torch.int32)
    of_req = torch.sum(torch.clamp(counts - cap_req, min=0),
                       dtype=torch.int32)
    slot = torch.where(
        mask_r & (within < cap_req),
        torch.arange(n_ranks, dtype=torch.int32, device=dev)[:, None]
        * cap_req + within, n_ranks * cap_req).reshape(-1).long()
    ids = torch.arange(l_glob, dtype=torch.int32, device=dev)
    req = _scatter(n_ranks * cap_req, slot, ids, -1, torch.int32)
    req_in = group.all_to_all(req)

    tpos = torch.where(req >= 0,
                       needed_pos[torch.clamp(req, 0, l_glob - 1).long()],
                       cap_table)
    own_pos = needed_pos[start:start + n_leaf_loc]
    own_needed = needed[start:start + n_leaf_loc]
    own_slot = torch.where(own_needed, own_pos, cap_table)
    of_table = torch.clamp(n_needed - cap_table, min=0)
    new_idx = torch.where(
        near_valid, needed_pos[torch.clamp(near_idx, 0, l_glob - 1).long()],
        0).to(torch.int32)
    work = bh_kernels.near_work(near_valid, new_idx, (0, cap_table))
    return _LetPlan(req_in, tpos, own_slot, new_idx,
                    (of_req + of_table).to(torch.int32), work)


def _let_table(pos_own, mass_own, lp: _LetPlan, cfg, *, group: RingGroup,
               leaf_size, n_leaf_loc):
    """Serve the requested tiles from current positions, one response
    all_to_all, scatter into the dense packed (cap_table * G, 4) source
    table at the plan's slots; rows never written stay zero-mass, inert."""
    _, cap_table = _let_caps(cfg, group.world_size, n_leaf_loc)
    start = group.rank * n_leaf_loc
    rows = torch.cat([pos_own, mass_own[:, None]], 1).reshape(
        n_leaf_loc, 4 * leaf_size)
    rel = torch.clamp(lp.req_in - start, 0, n_leaf_loc - 1).long()
    serve = rows[rel] * (lp.req_in >= 0).to(rows.dtype)[:, None]
    resp = group.all_to_all(serve)
    table = torch.zeros((cap_table + 1, 4 * leaf_size), dtype=rows.dtype,
                        device=rows.device)
    # Slots past the table (clipped imports keep their dense numbers) go
    # to the spare row, as the JAX package's drop mode discards them.
    table[torch.clamp(lp.tpos, max=cap_table).long()] = resp
    table[torch.clamp(lp.own_slot, max=cap_table).long()] = rows
    return table[:cap_table].reshape(cap_table * leaf_size, 4)


def _near_let_eval(pos_own, mass_own, tgt_leaves, near_valid, lp: _LetPlan,
                   cfg, *, group: RingGroup, leaf_size, n_leaf_loc,
                   compute_pot):
    """The near field through a (possibly frozen) LET import map: the
    source table (_let_table), then one launch of K1's table form over the
    remapped lists. Returns (acc, pot)."""
    src = _let_table(pos_own, mass_own, lp, cfg, group=group,
                     leaf_size=leaf_size, n_leaf_loc=n_leaf_loc)
    return bh_kernels.near_field(
        None, None, tgt_leaves, lp.new_idx, near_valid, g=cfg.g,
        softening=cfg.softening, compute_pot=compute_pot, work=lp.work,
        src_table=src)


# ------------------------------------------------------------------ ring
def _owned_tree(pos_own, mass_own, sentinel, cfg, *, leaf_size,
                group: RingGroup):
    """Distributed tree: local leaf summaries, one all_gather of the
    summary table (com, mass, radius and the quadrupole in one tensor), the
    replicated upper pyramid. Built afresh at every evaluation."""
    rows = leaf_rows(pos_own, mass_own, leaf_size, sentinel, cfg.bh_multipole)
    return tree_of_rows(group.all_gather(rows), sentinel,
                        max_levels=cfg.bh_max_levels)


def ring_windows(near_idx, near_valid, n_ranks, n_leaf_loc, rank,
                 leaf_size):
    """K1's work items for each rank's window of the ring near field, each
    window shaped by its own work (one host wait for all P windows; None
    entries on the CPU). The rank's own window, its first pass, writes the
    output, so its items cover every row; the others add into it and skip
    the rows with no entry in them."""
    if near_valid.device.type == "cpu":
        return [None] * n_ranks
    edges = [w * n_leaf_loc for w in range(n_ranks + 1)]
    return bh_kernels.near_windows(near_idx, near_valid, edges,
                                   writes=(rank,), leaf_size=leaf_size)


def _near_ring(pos_own, mass_own, tgt_leaves, near_idx, near_valid, cfg, *,
               group: RingGroup, n_leaf_loc, compute_pot, works=None):
    """Ring near field: the owned tiles rotate around the ring; pass p
    evaluates the window of leaves owned by rank (self - p) % P with K1's
    window form, the next rotation started before the pass computes. The
    first pass writes (acc, pot) and each later pass adds its window into
    them, in pass order. Returns (acc, pot)."""
    n_ranks, rank = group.world_size, group.rank
    if works is None:
        works = ring_windows(near_idx, near_valid, n_ranks, n_leaf_loc, rank,
                             tgt_leaves.shape[1])
    sh = torch.cat([pos_own, mass_own[:, None]], 1)
    out = None
    for p in range(n_ranks):
        nxt = group.shift_start(sh) if p < n_ranks - 1 else None
        owner = (rank - p) % n_ranks
        out = bh_kernels.near_field(
            sh[:, :3].contiguous(), sh[:, 3].contiguous(), tgt_leaves,
            near_idx, near_valid, g=cfg.g, softening=cfg.softening,
            compute_pot=compute_pot, work=works[owner],
            leaf_lo=owner * n_leaf_loc, out=out)
        if nxt is not None:
            sh = nxt.wait()
    return out


def _lists(tree, cfg, *, start, n_leaf_loc):
    """Traversal and lists (ops/bh.py _window_lists) for the target window
    [start, start + n_leaf_loc) in the refinement and far mode the config
    resolves to for the distributed tree. Returns (setup, near_idx,
    near_valid, far, overflow)."""
    setup = BHSetup.of(cfg, n_leaves=tree.com[0].shape[0])
    far_masks, rejects = traverse(tree, cfg.theta, start_leaf=start,
                                  n_slice=n_leaf_loc, stop_level=setup.stop)
    return (setup,) + _window_lists(tree, far_masks, rejects, setup, start,
                                    n_leaf_loc, setup.budgets(), None)


def _forces_owned(pos_own, mass_own, sentinel, cfg, *, group: RingGroup,
                  leaf_size, n_leaf_loc, compute_pot=True):
    """Tree, lists, far kernels (K2 octet; K4 gather) and the near field
    (ring or LET) for the owned key-range shard. Returns (acc, pot,
    overflow) in owned order."""
    tree = _owned_tree(pos_own, mass_own, sentinel, cfg, leaf_size=leaf_size,
                       group=group)
    tgt_leaves = pos_own.reshape(n_leaf_loc, leaf_size, 3)
    setup, near_idx, near_valid, far, of_lists = _lists(
        tree, cfg, start=group.rank * n_leaf_loc, n_leaf_loc=n_leaf_loc)
    acc, pot = _far_forces(tgt_leaves, far,
                           dataclasses.replace(setup, compute_pot=compute_pot))
    if cfg.bh_comm == "let":
        # A clipped import leaves an inert zero-mass tile and is counted.
        lp = _near_let_plan(near_idx, near_valid, cfg, group=group,
                            n_leaf_loc=n_leaf_loc)
        a, ph = _near_let_eval(pos_own, mass_own, tgt_leaves, near_valid, lp,
                               cfg, group=group, leaf_size=leaf_size,
                               n_leaf_loc=n_leaf_loc, compute_pot=compute_pot)
        return acc + a, pot + ph, of_lists + lp.overflow
    a, ph = _near_ring(pos_own, mass_own, tgt_leaves, near_idx, near_valid,
                       cfg, group=group, n_leaf_loc=n_leaf_loc,
                       compute_pot=compute_pot)
    return acc + a, pot + ph, of_lists


class _OwnedPlan(NamedTuple):
    """Frozen octet lists of the rank's target window (the distributed
    BHListPlan), with K1's items for each ring window and K2's order."""

    near_idx: torch.Tensor
    near_valid: torch.Tensor
    far_keys: torch.Tensor
    far_valid: torch.Tensor
    ring_work: list
    far_order: object


def _plan_owned(pos_own, mass_own, sentinel, cfg, *, group: RingGroup,
                leaf_size, n_leaf_loc):
    """Traversal and octet lists for the rank's window: the geometry half
    of _forces_owned, frozen across a rebuild interval. Returns (plan,
    overflow); the overflow is exact for the whole block."""
    tree = _owned_tree(pos_own, mass_own, sentinel, cfg, leaf_size=leaf_size,
                       group=group)
    _, ni, nv, (fk, fv, _), of = _lists(
        tree, cfg, start=group.rank * n_leaf_loc, n_leaf_loc=n_leaf_loc)
    works = (ring_windows(ni, nv, group.world_size, n_leaf_loc, group.rank,
                          leaf_size)
             if cfg.bh_comm == "ring" else None)
    return _OwnedPlan(ni, nv, fk, fv, works, bh_kernels.far_order(fv)), of


def _eval_owned(pos_own, mass_own, sentinel, plan: _OwnedPlan, cfg, *,
                group: RingGroup, leaf_size, n_leaf_loc, compute_pot,
                let_plan=None):
    """Frozen lists at current owned positions: a fresh distributed tree,
    K2 and the near field (the ring, or with let_plan the LET response
    exchange) against the frozen membership. Returns (acc, pot)."""
    tree = _owned_tree(pos_own, mass_own, sentinel, cfg, leaf_size=leaf_size,
                       group=group)
    nodes8 = _nodes_all_octet(tree, pos_own.dtype)
    tgt_leaves = pos_own.reshape(n_leaf_loc, leaf_size, 3)
    acc, pot = bh_kernels.far_octet(tgt_leaves, nodes8, plan.far_keys,
                                    plan.far_valid, g=cfg.g,
                                    softening=cfg.softening,
                                    compute_pot=compute_pot,
                                    order=plan.far_order)
    if let_plan is not None:
        a, ph = _near_let_eval(pos_own, mass_own, tgt_leaves,
                               plan.near_valid, let_plan, cfg, group=group,
                               leaf_size=leaf_size, n_leaf_loc=n_leaf_loc,
                               compute_pot=compute_pot)
    else:
        a, ph = _near_ring(pos_own, mass_own, tgt_leaves, plan.near_idx,
                           plan.near_valid, cfg, group=group,
                           n_leaf_loc=n_leaf_loc, compute_pot=compute_pot,
                           works=plan.ring_work)
    return acc + a, pot + ph


def _dist_reuse_eligible(cfg, n_steps: int) -> bool:
    """bh_rebuild_every > 1 applies to the distributed run for both near
    modes when the far mode resolves to octet (the JAX package's rule)."""
    if cfg.bh_rebuild_every <= 1 or n_steps <= 1:
        return False
    if cfg.resolve_force() != "barnes_hut":
        return False
    if cfg.bh_comm not in ("ring", "let"):
        return False
    return BHSetup.of(cfg).far_mode == "octet"


def _return_to_origin(cols_f, id_own, valid_own, *, group: RingGroup,
                      n_local, cap_pair):
    """Reverse exchange: each owned row's float columns go back to the rank
    and slot its global id names. Returns ((n_local,) columns, clipped)."""
    n_ranks, rank = group.world_size, group.rank
    id64 = id_own.long()
    dest_r = torch.where(valid_own, id64 // n_local, n_ranks)
    stay_r = valid_own & (dest_r == rank)
    slot_r = torch.where(stay_r, id64 % n_local, n_local)
    recv_f, (rid,), of_rev = _exchange(
        dest_r, valid_own & ~stay_r, cols_f, [id_own], [-1], group, cap_pair)
    rid = rid.long()
    arr_slot = torch.where(rid >= 0, rid % n_local, n_local)
    outs = []
    for c, r in zip(cols_f, recv_f):
        o = c.new_zeros((n_local + 1,))
        o[slot_r] = c            # stayers, then arrivals; the last slot
        o[arr_slot] = r          # takes the dropped rows
        outs.append(o[:n_local])
    return outs, of_rev


def dist_bh_accel(pos, mass, cfg, group: RingGroup, *, compute_pot=True):
    """Distributed Barnes-Hut accelerations of this rank's particle shard
    pos (n_local, 3) / mass (n_local,). Returns (acc, pot, overflow), the
    overflow (clipped exchange slots and list entries) summed over ranks;
    nonzero means degraded results: raise cfg.bh_pair_slack /
    cfg.bh_own_slack or the list budgets."""
    cfg = cfg.with_resolved_leaf(group.device)
    n_ranks, rank = group.world_size, group.rank
    n_local = pos.shape[0]
    leaf_size = cfg.resolve_bh_leaf_size()
    cap_pair, own_cap, n_leaf_loc = _plan_cfg(cfg, n_local, n_ranks,
                                              leaf_size)
    ids = rank * n_local + torch.arange(n_local, dtype=torch.int32,
                                        device=pos.device)
    valid = torch.ones((n_local,), dtype=torch.bool, device=pos.device)
    pos_own, _, mass_own, id_own, valid_own, sentinel, of_ex, _ = \
        _repartition(pos, [], mass, ids, valid, group=group,
                     cap_pair=cap_pair, own_cap=own_cap, n_live=n_local,
                     curve=cfg.bh_curve)
    acc, pot, of_lists = _forces_owned(
        pos_own, mass_own, sentinel, cfg, group=group, leaf_size=leaf_size,
        n_leaf_loc=n_leaf_loc, compute_pot=compute_pot)
    (ax, ay, az, po), of_rev = _return_to_origin(
        [acc[:, 0], acc[:, 1], acc[:, 2], pot], id_own, valid_own,
        group=group, n_local=n_local, cap_pair=cap_pair)
    overflow = group.all_reduce(
        (of_ex + of_rev + of_lists).to(torch.int32))
    return torch.stack([ax, ay, az], 1), po, overflow


def make_distributed_run(cfg, group: RingGroup, n_steps, debug_exchange=False):
    """n_steps distributed Barnes-Hut steps with a persistently key-sharded
    carry: one entry exchange, then each step repartitions only the
    boundary-crossing migrants (velocities and accelerations ride the same
    merge), and the origin-order state is rebuilt once at exit.

    cfg.bh_rebuild_every = k > 1 (_dist_reuse_eligible): blocks of one
    repartition + one traversal/list build (+ the LET request, once) per k
    steps, each step refreshing the distributed tree against the frozen
    lists; a trailing n_steps % k remainder runs as dt = 0 steps of the
    last block (an exact no-op), the block size chosen by
    api._reuse_block_size with the device's plan/eval ratio.

    Returns run(state) -> (state, overflow), the overflow summed over every
    step and rank; debug_exchange=True adds migrants (n_steps,), the count
    of particles that crossed a rank boundary at each step's repartition.
    Nonzero overflow here means the segment is corrupted (a particle
    clipped mid-run leaves the carry): discard it and redo it step by step
    (the CLI does)."""
    from parallelnbody_tpu_torch.api import _plan_ratio, _reuse_block_size
    from parallelnbody_tpu_torch.ops.integrators import get_integrator

    cfg = cfg.with_resolved_leaf(group.device)
    integrator = get_integrator(cfg.integrator)
    leaf_size = cfg.resolve_bh_leaf_size()
    reuse = _dist_reuse_eligible(cfg, n_steps) and not debug_exchange
    n_ranks, rank = group.world_size, group.rank
    compute_pot = cfg.track_potential

    def run(state):
        n_local = state.pos.shape[0]
        dev = state.pos.device
        cap_pair, own_cap, n_leaf_loc = _plan_cfg(cfg, n_local, n_ranks,
                                                  leaf_size)
        dt = torch.as_tensor(cfg.dt, dtype=state.pos.dtype, device=dev)
        ids0 = rank * n_local + torch.arange(n_local, dtype=torch.int32,
                                             device=dev)
        migs = []

        def repart(pos, vel, accv, potv, mass, pids, vmask):
            extras = [vel[:, 0], vel[:, 1], vel[:, 2],
                      accv[:, 0], accv[:, 1], accv[:, 2], potv]
            pos_o, ex_o, mass_o, id_o, _, sentinel, of, mig = _repartition(
                pos, extras, mass, pids, vmask, group=group,
                cap_pair=cap_pair, own_cap=own_cap, n_live=n_local,
                curve=cfg.bh_curve)
            if debug_exchange:
                migs.append(group.all_reduce(mig))
            return (pos_o, torch.stack(ex_o[0:3], 1),
                    torch.stack(ex_o[3:6], 1), ex_o[6], mass_o, id_o,
                    sentinel, of)

        def force_step(pos, vel, accv, potv, mass, sentinel, dt_eff):
            of_cell = [torch.zeros((), dtype=torch.int32, device=dev)]

            def accel_fn(p):
                a, ph, of = _forces_owned(
                    p, mass, sentinel, cfg, group=group, leaf_size=leaf_size,
                    n_leaf_loc=n_leaf_loc, compute_pot=compute_pot)
                of_cell[0] = of_cell[0] + of
                return a, ph

            pos, vel, accv, potv = integrator(accel_fn, pos, vel, accv,
                                              potv, dt_eff)
            return pos, vel, accv, potv, of_cell[0]

        t, st = state.time, state.step
        if reuse:
            k = _reuse_block_size(cfg.bh_rebuild_every, n_steps,
                                  _plan_ratio(dev))
            n_blocks, tail = divmod(n_steps, k)
            masks = [[1.0] * k] * n_blocks
            if tail:
                masks.append([1.0] * tail + [0.0] * (k - tail))
            # The block carry holds owned-capacity arrays: pad the shard
            # with invalid rows (id -1, mass 0) that the first block's
            # repartition drops.
            pad = own_cap - n_local
            z3 = state.pos.new_zeros((pad, 3))
            z1 = state.pos.new_zeros((pad,))
            pos = torch.cat([state.pos, z3])
            vel = torch.cat([state.vel, z3])
            accv = torch.cat([state.acc, z3])
            potv = torch.cat([state.pot, z1])
            mass = torch.cat([state.mass, z1])
            pids = torch.cat([ids0, torch.full((pad,), -1, dtype=torch.int32,
                                               device=dev)])
            of_total = torch.zeros((), dtype=torch.int32, device=dev)
            for row in masks:
                pos, vel, accv, potv, mass, pids, sentinel, of1 = repart(
                    pos, vel, accv, potv, mass, pids, pids >= 0)
                plan, of_p = _plan_owned(
                    pos, mass, sentinel, cfg, group=group,
                    leaf_size=leaf_size, n_leaf_loc=n_leaf_loc)
                lp = None
                if cfg.bh_comm == "let":
                    lp = _near_let_plan(plan.near_idx, plan.near_valid, cfg,
                                        group=group, n_leaf_loc=n_leaf_loc)
                    of_p = of_p + lp.overflow

                def accel_fn(p, mass=mass, sentinel=sentinel, plan=plan,
                             lp=lp):
                    return _eval_owned(
                        p, mass, sentinel, plan, cfg, group=group,
                        leaf_size=leaf_size, n_leaf_loc=n_leaf_loc,
                        compute_pot=compute_pot, let_plan=lp)

                for m in row:
                    dt_eff = dt * m
                    pos, vel, accv, potv = integrator(accel_fn, pos, vel,
                                                      accv, potv, dt_eff)
                    t = t + dt_eff
                    st = st + int(m > 0)
                of_total = of_total + of1 + of_p
        else:
            # The entry sort is step 1's sort; the in-loop repartition
            # starts at step 2.
            pos, vel, accv, potv, mass, pids, sentinel, of_total = repart(
                state.pos, state.vel, state.acc, state.pot, state.mass, ids0,
                torch.ones((n_local,), dtype=torch.bool, device=dev))
            for i in range(n_steps):
                if i:
                    pos, vel, accv, potv, mass, pids, sentinel, of1 = repart(
                        pos, vel, accv, potv, mass, pids, pids >= 0)
                    of_total = of_total + of1
                pos, vel, accv, potv, of2 = force_step(
                    pos, vel, accv, potv, mass, sentinel, dt)
                of_total = of_total + of2
                t, st = t + dt, st + 1

        cols = [pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1],
                vel[:, 2], accv[:, 0], accv[:, 1], accv[:, 2], potv]
        outs, of_rev = _return_to_origin(cols, pids, pids >= 0, group=group,
                                         n_local=n_local, cap_pair=cap_pair)
        out_state = state._replace(
            pos=torch.stack(outs[0:3], 1), vel=torch.stack(outs[3:6], 1),
            acc=torch.stack(outs[6:9], 1), pot=outs[9], time=t, step=st)
        of_out = group.all_reduce((of_total + of_rev).to(torch.int32))
        if debug_exchange:
            return out_state, of_out, torch.stack(migs)
        return out_state, of_out

    return run
