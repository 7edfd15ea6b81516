"""The near-field probe kernel: K8.

Counterpart of the Pallas kernel that `make_kernel(mode, unroll)` builds in
`scripts/near_kernel_probe.py` (a TPU experiment; no path of the JAX package
runs it), source csrc/near_probe.cu. It computes K1's near field for the
acceleration only over a table of source leaves cut into segments, in one of
the script's modes, so that its times say where K1's time per list entry
goes:

  * "A": the table row of each list entry (the shipped form);
  * "B": row k % rows of the segment (k the list position): A's loop and
    math without the indirect read;
  * "C": row 0: without the read of a new row either;
  * "E": as A, with a trip's `unroll` tiles staged before any arithmetic;
  * "F" is A with n_comp = 8: sources 8 floats apart in the table, as the
    script pads its rows to 8 components.

Inputs are the script's: target leaves tgt_t (L, 4, G) [x; y; z; 0], source
leaves table (L, 4, G) [x; y; z; m], the front-packed ascending near lists
idx (L, B) int32 / valid (L, B) bool of leaf ids, and the table's segment
size rows_per_seg (a divisor of L). `probe_bounds` gives each row's run
[lo, hi) of list positions in each segment, as the script's `make_bnd`.
The output is (L, 4, G) [ax; ay; az; 0] (raw sums, no G factor), each
target's sum over the segments in segment order. In a segment each entry's
tile is summed on its own, then added to the target's carry in list order;
`unroll` entries make a trip and a trip past hi keeps the script's tail rule
(the row of hi - 1, the mass times k < hi: zeros).

The segment base. The script's kernel reads a segment's table block by the
global leaf id; only the first segment is right that way. The shipped K1
subtracts the segment's base (parallelnbody_tpu/ops/pallas_bh.py:214), and
so does this kernel: the port computes what the script means.

`near_probe` dispatches on the device of its tensors (kernels/launch.py):
CPU tensors run `near_probe_plain`, CUDA tensors launch the kernel once per
segment (`LAUNCHES["near_probe"]` counts each) on the table packed by
`probe_table` into the card's layout (L, G, n_comp), or raise. f32 only;
G at most 1024 (mode E: unroll x G at most 7168, its two trips of tiles in
one block's shared memory).

The kernel runs work items, as K1 does: `probe_items` cuts each row's run
[lo, hi) of a segment into items of at most `bh_kernels.NEAR_CHUNK`
entries (`bh_kernels.near_items`, heaviest first; in segment 0 a row with
no entry gets one empty item, which writes its zeros), one block each.
The sums of a split row's items are added in chunk order, then written
(segment 0) or added to the row (later segments): the plain version's
order but for where the items cut a segment's carry, so kernel and plain
version agree to f32 rounding (rtol 2e-4 / atol 2e-5, the kernels' parity
bound).
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.kernels.launch import check, launch, on_cpu, ptr
from parallelnbody_tpu_torch.ops import bh_kernels

LAUNCHES = {"near_probe": 0}
MODES = {"A": 0, "B": 1, "C": 2, "E": 3}
UNROLLS = (4, 8)
N_COMPS = (4, 8)
EPS2 = 1e-4   # the script's eps2 (softening 0.01)

# Mode E holds two trips of `unroll` tiles of G float4 in shared memory,
# at most 227 KB a block on the card.
_E_TILES_MAX = 227 * 1024 // (2 * 16)
# Element budget of one plain-version temporary (rows x G x G).
_PLAIN_BLOCK_ELEMS = 1 << 25


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def probe_bounds(idx, valid, rows_per_seg):
    """(L, n_seg + 1) int32: row t's entries in segment s are list
    positions [bnd[t, s], bnd[t, s + 1]) (the script's make_bnd: the count
    of valid ids below each segment's first leaf, then the row's count)."""
    n_leaves = idx.shape[0]
    cuts = [torch.sum(valid & (idx < s * rows_per_seg), dim=1,
                      dtype=torch.int32)
            for s in range(1, n_leaves // rows_per_seg)]
    zero = torch.zeros(n_leaves, dtype=torch.int32, device=idx.device)
    full = torch.sum(valid, dim=1, dtype=torch.int32)
    return torch.stack([zero, *cuts, full], dim=1).contiguous()


def probe_items(bnd, chunk=bh_kernels.NEAR_CHUNK):
    """The kernel's work items for the bounds bnd (L, n_seg + 1)
    (`probe_bounds`): for each segment s, a `bh_kernels.NearWork` whose
    items cut each row's positions [bnd[t, s], bnd[t, s + 1]) into runs of
    at most `chunk`, heaviest first (`bh_kernels.near_items`); in segment 0
    every row has an item, later an empty run has none. Reads three sizes
    a segment back to the host: build them once per list set."""
    counts = bnd[:, 1:] - bnd[:, :-1]
    return [bh_kernels.near_items(counts[:, s], chunk, lo=bnd[:, s],
                                  every_row=s == 0)
            for s in range(counts.shape[1])]


def probe_table(table, n_comp=4):
    """The card's layout of the source table (L, 4, G): (L, G, n_comp),
    each source [x, y, z, m] followed by n_comp - 4 zeros."""
    t = table.transpose(1, 2)
    if n_comp > 4:
        t = torch.cat([t, t.new_zeros(t.shape[:2] + (n_comp - 4,))], dim=2)
    return t.contiguous()


def _check_args(tgt_t, table, idx, valid, mode, unroll, rows_per_seg,
                n_comp):
    if tgt_t.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"near_probe: float32 only (tgt_t {tgt_t.dtype}, "
                        f"table {table.dtype})")
    if tgt_t.dim() != 3 or tgt_t.shape[1] != 4 or \
            tuple(table.shape) != tuple(tgt_t.shape):
        raise ValueError(f"near_probe: tgt_t and table (L, 4, G), got "
                         f"{tuple(tgt_t.shape)} and {tuple(table.shape)}")
    n_leaves, _, g = tgt_t.shape
    if idx.dim() != 2 or idx.shape[0] != n_leaves or \
            tuple(valid.shape) != tuple(idx.shape):
        raise ValueError(f"near_probe: idx and valid (L, B), got "
                         f"{tuple(idx.shape)} and {tuple(valid.shape)}")
    if mode not in MODES or unroll not in UNROLLS or n_comp not in N_COMPS:
        raise ValueError(f"near_probe: mode {mode!r} of {sorted(MODES)}, "
                         f"unroll {unroll} of {UNROLLS}, n_comp {n_comp} of "
                         f"{N_COMPS}")
    if rows_per_seg <= 0 or n_leaves % rows_per_seg:
        raise ValueError(f"near_probe: rows_per_seg {rows_per_seg} must "
                         f"divide the {n_leaves} leaves")
    if not 0 < g <= 1024:
        raise ValueError(f"near_probe: leaf size {g} must be in 1..1024")
    if mode == "E" and unroll * g > _E_TILES_MAX:
        raise ValueError(f"near_probe: mode E stages 2 x {unroll} tiles of "
                         f"{g} sources, more than a block's shared memory")


def near_probe_plain(tgt_t, table, idx, valid, *, mode, unroll,
                     rows_per_seg, n_comp=4, eps2=EPS2):
    """K8's output (L, 4, G) in plain torch, in the kernel's order: for each
    segment, the entries of each row in list order (each tile summed over
    its G sources, then added into the carry), the segments added in
    order. Modes E and F compute A's function (the tail entries, whose
    masses are zero, add nothing and are not formed here); unroll does not
    change the order."""
    _check_args(tgt_t, table, idx, valid, mode, unroll, rows_per_seg, n_comp)
    n_leaves, _, g = tgt_t.shape
    bnd = probe_bounds(idx, valid, rows_per_seg).long()
    tgt = tgt_t[:, :3].transpose(1, 2)            # (L, G, 3)
    src = table.transpose(1, 2)                   # (L, G, 4)
    out = torch.zeros_like(tgt_t)
    block = max(1, _PLAIN_BLOCK_ELEMS // (g * g))
    for s in range(n_leaves // rows_per_seg):
        base = s * rows_per_seg
        lo, hi = bnd[:, s], bnd[:, s + 1]
        carry = tgt.new_zeros(tgt.shape)
        for k in range(int((hi - lo).max()) if n_leaves else 0):
            rows = torch.nonzero(lo + k < hi).squeeze(1)
            pos = lo[rows] + k
            if mode in ("A", "E"):
                leaf = idx[rows, pos].long()
            elif mode == "B":
                leaf = base + pos % rows_per_seg
            else:
                leaf = torch.full_like(rows, base)
            for r0 in range(0, rows.shape[0], block):
                r, lf = rows[r0:r0 + block], leaf[r0:r0 + block]
                p = src[lf]                                   # (n, G, 4)
                d = p[:, None, :, :3] - tgt[r][:, :, None, :]  # (n, G, G, 3)
                r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2]) + eps2
                u = torch.rsqrt(r2)
                w = (p[:, None, :, 3] * u) * (u * u)
                carry[r] = carry[r] + torch.sum(w[..., None] * d, dim=2)
        out[:, :3] = out[:, :3] + carry.transpose(1, 2)
    return out


def near_probe(tgt_t, table, idx, valid, *, mode, unroll, rows_per_seg,
               n_comp=4, eps2=EPS2, bnd=None, packed=None, items=None):
    """K8 on the lists idx/valid (see the module docstring). CPU tensors
    run `near_probe_plain`; CUDA tensors launch the kernel once per segment.
    bnd (`probe_bounds`), packed (`probe_table(table, n_comp)`) and items
    (`probe_items(bnd)`) may come built beforehand, as the script builds
    its bounds outside the timed call; else they are built here."""
    if on_cpu(tgt_t, table, idx, valid):
        return near_probe_plain(tgt_t, table, idx, valid, mode=mode,
                                unroll=unroll, rows_per_seg=rows_per_seg,
                                n_comp=n_comp, eps2=eps2)
    _check_args(tgt_t, table, idx, valid, mode, unroll, rows_per_seg, n_comp)
    n_leaves, _, g = tgt_t.shape
    budget = idx.shape[1]
    n_seg = n_leaves // rows_per_seg
    check("tgt_t", tgt_t, torch.float32, (n_leaves, 4, g))
    check("idx", idx, torch.int32, (n_leaves, budget))
    if bnd is None:
        bnd = probe_bounds(idx, valid, rows_per_seg)
    if packed is None:
        packed = probe_table(table, n_comp)
    check("bnd", bnd, torch.int32, (n_leaves, n_seg + 1))
    check("packed", packed, torch.float32, (n_leaves, g, n_comp))
    if packed.data_ptr() % 16:
        raise ValueError("near_probe: packed must start on a 16-byte "
                         "boundary (the kernel copies float4)")
    if items is None:
        items = probe_items(bnd)
    if len(items) != n_seg or not items[0].every_row:
        raise ValueError(f"near_probe: items for {n_seg} segments, the "
                         "first covering every row (probe_items)")
    n_partial = max(w.n_partial for w in items)
    partial = torch.empty((max(n_partial, 1) * g, 4), dtype=torch.float32,
                          device=tgt_t.device)
    out = torch.empty_like(tgt_t)
    for s, work in enumerate(items):
        launch(LAUNCHES, "near_probe", "pnb_near_probe", ptr(work.items),
               ptr(work.splits), ptr(idx), ptr(tgt_t), ptr(packed), ptr(out),
               ptr(partial), work.items.shape[0], work.splits.shape[0], g,
               budget, s * rows_per_seg, rows_per_seg, n_comp, MODES[mode],
               unroll, int(s > 0), float(eps2))
    return out
