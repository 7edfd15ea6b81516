"""The flat-list near-field kernels: K9, K10 and K11.

Counterparts of three TPU experiments (no path of the JAX package runs
them), one source, csrc/near_flat.cu:

  * `flat_near` replaces `kernel` of `scripts/flat_kernel_proto.py` (via
    `flat_near`): 4 packs a step, eps2, guard_zero and compute_pot as
    arguments;
  * `flat_tune` replaces `make_kernel(step_packs, out_mode)` of
    `scripts/flat_kernel_tune.py` (via `run`): 4, 8 or 16 packs a step,
    out_mode "rmw" (the row's sum carried from step to step) or "steps"
    (one partial a step, added up afterwards as the script's segment_sum);
  * `flat_tune2` replaces `make_kernel(step_packs, mode, g)` of
    `scripts/flat_kernel_tune2.py` (via `run`): sums kept per source lane,
    reduced over the lanes once a step (mode "step") or once a row ("row").

The work list (the scripts' inputs): rows (S,) int32, the target row of
each step, ascending, every row of tgt_t owning at least one step;
tgt_t (Ls, 4, G) [x; y; z; -]; src (S, P, 4, 128) f32, step c's P packs of
128 sources [x; y; z; m]. Each returns out (Ls, 4, G), the raw sums
[sum w dx; sum w dy; sum w dz; sum m u] of each target over its row's
sources, u = rsqrt(r^2 + eps^2) (0 where r^2 = 0 with guard_zero),
w = m u^3, the last row zero without the potential. K10 and K11 take the
scripts' eps2 = 1e-2 and compute_pot = True unless told otherwise.

Summation order, each the script's, in the kernels and in the plain
versions (`*_plain`) alike: K9 and K10 sum each pack over its 128 sources,
add the packs into the step's sum and the steps into the row's in order;
K11 adds each pack's terms into per-lane sums (G x 128 a component) and
reduces the lanes once a step, the step's sum then added into the row's,
or once a row, the lane sums carried across the row's steps.

`pack_lists` cuts K1's near lists into this form (each entry G / 32
sub-tiles of 32 sources, 4 to a pack, each row padded with zero-mass
sub-tiles to whole steps): the same pairs that K1 evaluates.

K11's kernel runs work items (`lane_items`): each row's steps cut into
items of at most `lane_chunk(step_packs)` steps (8192 sources, as many as
K1's item of `bh_kernels.NEAR_CHUNK` leaves of 256), heaviest first
(`bh_kernels.near_items`), one block each. In an item a target keeps one
partial sum per slice of 32 of a pack's 128 lanes, reduced in slice order
once a step ("step") or once at the item's end ("row"), and a split row's
item sums are added in item order. That is the plain version's order but
for the lanes grouped four to a target and, in "row", the lanes reduced at
each item's end rather than the row's: the same f32 terms in another
order, so kernel and plain version agree to rtol 2e-4 / atol 2e-5, the
kernels' parity bound.

The wrappers check the scripts' precondition (rows ascending, every row
owning a step) and raise if it fails; they dispatch on the device of their
tensors (kernels/launch.py): CPU tensors run the plain version, CUDA
tensors launch the kernel or raise. f32 only; G at most 1024, K11 also a
multiple of 32. `LAUNCHES` counts calls of the C entry under each
wrapper's name; K10 "steps" and K11 on a row cut into several items run
two kernels a call (the partials, then the combining pass), every other
form one.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.kernels.launch import check, launch, on_cpu, ptr
from parallelnbody_tpu_torch.ops import bh_kernels

LAUNCHES = {"flat_near": 0, "flat_tune": 0, "flat_tune2": 0}
LANES = 128          # sources a pack
SUB = 32             # sources a sub-tile
PACK_SUBS = 4        # sub-tiles a pack
PROTO_PACKS = 4      # flat_kernel_proto.py STEP_PACKS
STEP_PACKS = (4, 8, 16)
OUT_MODES = ("rmw", "steps")
LANE_MODES = ("step", "row")
TUNE_EPS2 = 1e-2     # the tune scripts' make_kernel default
# K9's and K10's launch shapes in their C entry (csrc/near_flat.cu).
_SHAPES = {"rmw": 0, "steps": 1}
_LANE_MULTIPLE = 32  # K11's leaf size: whole warps of targets
# Sources of one K11 work item: K1's item, NEAR_CHUNK leaves of 256.
LANE_ITEM_SOURCES = bh_kernels.NEAR_CHUNK * 256

# Element budget of one plain-version temporary (steps x G x 128 x 4).
_PLAIN_BLOCK_ELEMS = 1 << 25


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def row_starts(rows, n_rows):
    """(n_rows + 1,) int32: row r owns steps [starts[r], starts[r + 1]).
    Raises ValueError unless rows (S,) ascends and every row of
    [0, n_rows) owns at least one step (the scripts' precondition); one
    host read."""
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise ValueError(f"rows: (S,) int32, got {tuple(rows.shape)} "
                         f"{rows.dtype}")
    if rows.shape[0] < max(n_rows, 1) or not bool(
            (rows[0] == 0) & (rows[-1] == n_rows - 1)
            & torch.all((rows[1:] - rows[:-1] >= 0)
                        & (rows[1:] - rows[:-1] <= 1))):
        raise ValueError(f"rows must ascend from 0 to {n_rows - 1} with "
                         "every row owning at least one step")
    marks = torch.arange(n_rows + 1, dtype=rows.dtype, device=rows.device)
    return torch.searchsorted(rows, marks).to(torch.int32)


def _check_args(rows, tgt_t, src, step_packs, lanes=False):
    if tgt_t.dtype != torch.float32 or src.dtype != torch.float32:
        raise TypeError(f"flat kernels: float32 only (tgt_t {tgt_t.dtype}, "
                        f"src {src.dtype})")
    if tgt_t.dim() != 3 or tgt_t.shape[1] != 4:
        raise ValueError(f"tgt_t: (Ls, 4, G), got {tuple(tgt_t.shape)}")
    if step_packs not in STEP_PACKS or \
            tuple(src.shape) != (rows.shape[0], step_packs, 4, LANES):
        raise ValueError(f"src: (S, P, 4, {LANES}) with S = len(rows) and "
                         f"P = step_packs of {STEP_PACKS}, got "
                         f"{tuple(src.shape)}, step_packs {step_packs}")
    g = tgt_t.shape[2]
    if not 0 < g <= 1024 or (lanes and g % _LANE_MULTIPLE):
        raise ValueError(f"leaf size {g}: 1..1024"
                         + (f", a multiple of {_LANE_MULTIPLE}" if lanes
                            else ""))
    return row_starts(rows, tgt_t.shape[0])


# ------------------------------------------------------------ plain versions
def _terms(tgt, pack, eps2, guard_zero, compute_pot):
    """The pair terms (n, G, 128, 4) [w dx, w dy, w dz, m u] of targets
    tgt (n, G, 3) against packs (n, 4, 128)."""
    d = pack[:, None, :3, :] - tgt[:, :, :, None]           # (n, G, 3, 128)
    r2 = (d[:, :, 0] * d[:, :, 0] + d[:, :, 1] * d[:, :, 1]
          + d[:, :, 2] * d[:, :, 2]) + eps2
    u = torch.rsqrt(r2)
    if guard_zero:
        u = torch.where(r2 > 0, u, torch.zeros_like(u))
    mu = pack[:, None, 3, :] * u
    w = mu * (u * u)
    pot = mu if compute_pot else torch.zeros_like(mu)
    return torch.stack([w * d[:, :, 0], w * d[:, :, 1], w * d[:, :, 2], pot],
                       dim=-1)


def _chunk(g):
    return max(1, _PLAIN_BLOCK_ELEMS // (g * LANES * 4))


def _step_sums(rows, tgt, src, eps2, guard_zero, compute_pot, lanes):
    """(S, G, 4): each step's sum, as K9/K10 form it (each pack summed over
    its sources, the packs added in order) or, lanes, as K11's "step" does
    (per-lane sums over the packs, then reduced over the lanes)."""
    n_steps, packs = src.shape[:2]
    out = tgt.new_zeros((n_steps, tgt.shape[1], 4))
    block = _chunk(tgt.shape[1])
    for c0 in range(0, n_steps, block):
        t = tgt[rows[c0:c0 + block].long()]
        acc = None
        for j in range(packs):
            terms = _terms(t, src[c0:c0 + block, j], eps2, guard_zero,
                           compute_pot)
            part = terms if lanes else terms.sum(dim=2)
            acc = part if acc is None else acc + part
        out[c0:c0 + block] = acc.sum(dim=2) if lanes else acc
    return out


def _rows_in_order(starts, per_step, shape):
    """out (Ls, ...) = each row's per_step entries added in step order
    (out zero, then + step 0, + step 1, ...)."""
    counts = (starts[1:] - starts[:-1]).long()
    out = per_step.new_zeros(shape)
    for k in range(int(counts.max()) if counts.numel() else 0):
        act = torch.nonzero(counts > k).squeeze(1)
        out[act] = out[act] + per_step[starts[act].long() + k]
    return out


def _lane_rows(starts, tgt, src, eps2, compute_pot):
    """K11 "row": (Ls, G, 4), the per-lane sums of each row carried across
    its steps in order (pack by pack) and reduced over the lanes once."""
    counts = (starts[1:] - starts[:-1]).long()
    n_rows, g, _ = tgt.shape
    lanes = tgt.new_zeros((n_rows, g, LANES, 4))
    block = _chunk(g)
    for k in range(int(counts.max()) if counts.numel() else 0):
        act = torch.nonzero(counts > k).squeeze(1)
        for a0 in range(0, act.shape[0], block):
            a = act[a0:a0 + block]
            c = starts[a].long() + k
            for j in range(src.shape[1]):
                lanes[a] = lanes[a] + _terms(tgt[a], src[c, j], eps2, False,
                                             compute_pot)
    return lanes.sum(dim=2)


def _flat_plain(rows, tgt_t, src, *, eps2, guard_zero, compute_pot, shape,
                starts):
    tgt = tgt_t[:, :3].transpose(1, 2)                        # (Ls, G, 3)
    out_shape = (tgt_t.shape[0], tgt_t.shape[2], 4)
    if shape == "row":
        out = _lane_rows(starts, tgt, src, eps2, compute_pot)
    else:
        per_step = _step_sums(rows, tgt, src, eps2, guard_zero, compute_pot,
                              lanes=shape == "step")
        if shape == "steps":   # the script's segment_sum
            out = per_step.new_zeros(out_shape).index_add_(0, rows.long(),
                                                           per_step)
        else:
            out = _rows_in_order(starts, per_step, out_shape)
    return out.transpose(1, 2).contiguous()


def _plain(rows, tgt_t, src, step_packs, shape, eps2, guard_zero,
           compute_pot):
    starts = _check_args(rows, tgt_t, src, step_packs,
                         lanes=shape in LANE_MODES)
    return _flat_plain(rows, tgt_t, src, eps2=eps2, guard_zero=guard_zero,
                       compute_pot=compute_pot, shape=shape, starts=starts)


def _mode(mode, modes):
    if mode not in modes:
        raise ValueError(f"mode {mode!r} of {modes}")
    return mode


def flat_near_plain(rows, tgt_t, src, *, eps2, guard_zero=False,
                    compute_pot=True):
    """K9's output (Ls, 4, G) in plain torch."""
    return _plain(rows, tgt_t, src, PROTO_PACKS, "rmw", eps2, guard_zero,
                  compute_pot)


def flat_tune_plain(rows, tgt_t, src, *, step_packs, out_mode,
                    compute_pot=True, eps2=TUNE_EPS2):
    """K10's output (Ls, 4, G) in plain torch ("steps": the step partials
    added up by index_add_, as the script's segment_sum)."""
    return _plain(rows, tgt_t, src, step_packs, _mode(out_mode, OUT_MODES),
                  eps2, False, compute_pot)


def flat_tune2_plain(rows, tgt_t, src, *, step_packs, mode, compute_pot=True,
                     eps2=TUNE_EPS2):
    """K11's output (Ls, 4, G) in plain torch."""
    return _plain(rows, tgt_t, src, step_packs, _mode(mode, LANE_MODES),
                  eps2, False, compute_pot)


# ------------------------------------------------------------------ kernels
def lane_chunk(step_packs):
    """K11's steps an item at step_packs packs a step: LANE_ITEM_SOURCES
    sources (16, 8, 4 steps at 4, 8, 16 packs)."""
    return max(1, LANE_ITEM_SOURCES // (step_packs * LANES))


def lane_items(rows, n_rows, step_packs):
    """K11's work items for the steps' rows (S,) int32 of n_rows target
    rows: a `bh_kernels.NearWork` whose items cut each row's steps
    [starts[r], starts[r + 1]) (`row_starts`, which checks the scripts'
    precondition) into runs of at most `lane_chunk(step_packs)` steps,
    heaviest first; begin and end are step indices. Reads sizes back to
    the host: build them once per work list."""
    starts = row_starts(rows, n_rows)
    return bh_kernels.near_items(starts[1:] - starts[:-1],
                                 lane_chunk(step_packs), lo=starts[:-1])


def _check_tensors(rows, tgt_t, src, step_packs):
    n_rows, _, g = tgt_t.shape
    n_steps = rows.shape[0]
    check("rows", rows, torch.int32, (n_steps,))
    check("tgt_t", tgt_t, torch.float32, (n_rows, 4, g))
    check("src", src, torch.float32, (n_steps, step_packs, 4, LANES))


def _flat(name, rows, tgt_t, src, step_packs, shape, eps2, guard_zero,
          compute_pot):
    """K9 and K10: the plain version on CPU tensors, else the kernel in
    launch shape `shape` under the launch count `name`."""
    if on_cpu(rows, tgt_t, src):
        return _plain(rows, tgt_t, src, step_packs, shape, eps2, guard_zero,
                      compute_pot)
    starts = _check_args(rows, tgt_t, src, step_packs)
    _check_tensors(rows, tgt_t, src, step_packs)
    n_rows, _, g = tgt_t.shape
    n_steps = rows.shape[0]
    out = torch.empty_like(tgt_t)
    partial = torch.empty((n_steps if shape == "steps" else 0, 4, g),
                          dtype=torch.float32, device=tgt_t.device)
    launch(LAUNCHES, name, "pnb_near_flat", ptr(starts), ptr(rows),
           ptr(tgt_t), ptr(src), ptr(out), ptr(partial), n_rows, n_steps, g,
           step_packs, _SHAPES[shape], float(eps2), int(bool(guard_zero)),
           int(bool(compute_pot)))
    return out


def flat_near(rows, tgt_t, src, *, eps2, guard_zero=False, compute_pot=True):
    """K9: the flat-list near field, 4 packs a step (ROW launch shape)."""
    return _flat("flat_near", rows, tgt_t, src, PROTO_PACKS, "rmw", eps2,
                 guard_zero, compute_pot)


def flat_tune(rows, tgt_t, src, *, step_packs, out_mode, compute_pot=True,
              eps2=TUNE_EPS2):
    """K10: step_packs 4, 8 or 16; out_mode "rmw" (ROW launch shape) or
    "steps" (STEPS: a partial a step, then the combining pass)."""
    return _flat("flat_tune", rows, tgt_t, src, step_packs,
                 _mode(out_mode, OUT_MODES), eps2, False, compute_pot)


def flat_tune2(rows, tgt_t, src, *, step_packs, mode, compute_pot=True,
               eps2=TUNE_EPS2, work=None):
    """K11: per-lane sums, reduced once a step ("step") or once at the end
    of an item's steps ("row"); one block per work item. work
    (`lane_items(rows, Ls, step_packs)`) may come built beforehand, once
    per work list (its build checked the rows); else it is built here."""
    _mode(mode, LANE_MODES)
    if on_cpu(rows, tgt_t, src):
        return _plain(rows, tgt_t, src, step_packs, mode, eps2, False,
                      compute_pot)
    if work is None:
        _check_args(rows, tgt_t, src, step_packs, lanes=True)
        work = lane_items(rows, tgt_t.shape[0], step_packs)
    elif tgt_t.shape[2] % _LANE_MULTIPLE:
        raise ValueError(f"leaf size {tgt_t.shape[2]}: a multiple of "
                         f"{_LANE_MULTIPLE}")
    _check_tensors(rows, tgt_t, src, step_packs)
    g = tgt_t.shape[2]
    out = torch.empty_like(tgt_t)
    partial = torch.empty((max(work.n_partial, 1) * g, 4),
                          dtype=torch.float32, device=tgt_t.device)
    launch(LAUNCHES, "flat_tune2", "pnb_near_flat_lanes", ptr(work.items),
           ptr(work.splits), ptr(tgt_t), ptr(src), ptr(out), ptr(partial),
           work.items.shape[0], work.splits.shape[0], g, step_packs,
           int(mode == "row"), int(bool(compute_pot)), float(eps2))
    return out


# ------------------------------------------------------------ K1's lists
def pack_lists(src_leaves, idx, valid, step_packs):
    """K1's near lists in the flat form. src_leaves (n_leaves, G, 4)
    [x, y, z, m] (the sorted particles by leaf); idx (L, B) int32 /
    valid (L, B) bool front-packed lists of source leaves of each target
    row. Each entry becomes G / 32 sub-tiles of 32 sources, packed 4 to a
    pack in list order, and each row is padded with zero-mass sub-tiles
    (at the origin) to whole steps of step_packs packs; a row with no entry
    gets one step of them. Returns (rows (S,) int32, src (S, P, 4, 128),
    live sub-tiles, all sub-tiles)."""
    n_src, g, _ = src_leaves.shape
    if g % SUB:
        raise ValueError(f"leaf size {g} must be a multiple of {SUB}")
    dev = src_leaves.device
    per_entry = g // SUB
    per_step = step_packs * PACK_SUBS
    subs = torch.cat([src_leaves.reshape(n_src * per_entry, SUB, 4),
                      src_leaves.new_zeros((1, SUB, 4))])
    zero_sub = n_src * per_entry
    counts = torch.sum(valid, dim=1)
    steps = torch.clamp_min((counts * per_entry + per_step - 1) // per_step, 1)
    n_rows = counts.shape[0]
    slots = steps * per_step
    slot_row = torch.repeat_interleave(torch.arange(n_rows, device=dev), slots)
    first = torch.cumsum(slots, 0) - slots
    q = torch.arange(slot_row.shape[0], device=dev) - first[slot_row]
    entry = q // per_entry
    live = entry < counts[slot_row]
    leaf = idx[slot_row, torch.clamp(entry, max=idx.shape[1] - 1)].long()
    sub = torch.where(live, leaf * per_entry + q % per_entry, zero_sub)
    n_steps = int(slot_row.shape[0]) // per_step
    src = subs[sub].reshape(n_steps, step_packs, PACK_SUBS, SUB, 4)
    src = src.permute(0, 1, 4, 2, 3).reshape(n_steps, step_packs, 4, LANES)
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=dev, dtype=torch.int32), steps)
    return rows, src.contiguous(), int(live.sum()), int(live.shape[0])
