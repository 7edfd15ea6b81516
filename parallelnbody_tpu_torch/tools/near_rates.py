"""The card's near-field rates, by which the list-statistics tools
(tools/near_refine_probe.py, tools/cell_leaves_probe.py) turn pair counts
into milliseconds, measured in the same run on the lists the tool built:

  * K1 (`bh_kernels.near_field`, compute_pot=False, its work items built
    beforehand): the pair terms it executes (live list entries x G x G)
    over its events seconds;
  * K11 "row" (`near_flat.flat_tune2`, K11_PACKS packs a step, with the
    potential, as flat_kernel_tune2.py ran it, its work items built
    beforehand): the same lists cut into the flat form
    (`near_flat.pack_lists`), the live pairs over its events seconds.

Each timed launch's first output is held against the plain version on
SAMPLE_ROWS target rows spread over the lists (K1 elementwise, K11 to each
row's scale, rtol 2e-4 / atol 2e-5). On the CPU (the tests) nothing is
launched or timed and every rate is None.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.ops import bh, bh_kernels, near_flat
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.tools.flat_kernel import held_rows

SOFTENING = 0.01            # the scripts' softening
RTOL, ATOL = 2e-4, 2e-5     # chip_smoke.py's parity bound
SAMPLE_ROWS = 32
K11_PACKS = 8
FLOPS_PAIR_POT = 19         # K1's pair (18) and the potential's add


def compact_keys(keys):
    """Front-packed ascending lists (idx (L, B) int32, valid (L, B)) of
    the keys (INT32_MAX = none) of each row, B = the longest row."""
    width = max(1, int(torch.max(torch.sum(keys != bh.INT32_MAX, dim=1))))
    idx, valid, _ = bh._keys_compact(keys, width)
    return idx.contiguous(), valid


def mask_lists(mask):
    """`compact_keys` of the True columns of each row of mask."""
    return compact_keys(torch.where(
        mask, bh._iota(*mask.shape, mask.device), bh.INT32_MAX))


def sample_rows(n_rows, device, k=SAMPLE_ROWS):
    """k row ids spread evenly over n_rows, the first and the last among
    them."""
    return torch.unique(torch.linspace(0, n_rows - 1, k).round()
                        .long()).to(device)


def k1_rate(pos_s, mass_s, idx, valid, iters=measure.ITERS):
    """K1 on the lists (idx, valid) over the sorted particles: {"k1_ms",
    "k1_pairs", "k1_pairs_per_s", "k1_bound_ms", "k1_share",
    "k1_max_abs_err"}."""
    n_leaves = idx.shape[0]
    g = pos_s.shape[0] // n_leaves
    tgt = pos_s.reshape(n_leaves, g, 3)
    work = bh_kernels.near_work(valid)
    (acc, _), ms = measure.timed(lambda: bh_kernels.near_field(
        pos_s, mass_s, tgt, idx, valid, g=1.0, softening=SOFTENING,
        compute_pot=False, work=work), iters)
    rows = sample_rows(n_leaves, idx.device)
    want, _ = bh_kernels.near_field_plain(
        pos_s, mass_s, tgt[rows], idx[rows], valid[rows], g=1.0,
        softening=SOFTENING, compute_pot=False)
    err = measure.max_abs_err("K1 near_field", acc.reshape(
        n_leaves, g, 3)[rows].reshape(-1, 3), want, RTOL, ATOL)
    entries = int(valid.sum())
    n_bytes = (pos_s.numel() + mass_s.numel() + 2 * tgt.numel()) * 4 \
        + entries * 4
    b = measure.pair_bound(entries * g * g, measure.FLOPS_MONOPOLE, n_bytes)
    return {"k1_ms": ms, "k1_pairs": b["pairs"],
            "k1_pairs_per_s": b["pairs"] / (ms * 1e-3),
            "k1_bound_ms": b["bound_ms"], "k1_share": b["bound_ms"] / ms,
            "k1_max_abs_err": err}


def k11_row_rate(pos_s, mass_s, idx, valid, iters=measure.ITERS):
    """K11 "row" at K11_PACKS packs on the flat form of the lists:
    {"k11_ms", "k11_pairs", "k11_pairs_per_s", "k11_bound_ms",
    "k11_share", "k11_padding_share", "k11_max_abs_err"}."""
    n_leaves = idx.shape[0]
    g = pos_s.shape[0] // n_leaves
    tgt = pos_s.reshape(n_leaves, g, 3)
    src_leaves = torch.cat([tgt, mass_s.reshape(n_leaves, g, 1)], dim=2)
    rows, src, live, subs = near_flat.pack_lists(src_leaves, idx, valid,
                                                 K11_PACKS)
    tgt_t = torch.cat([tgt, torch.zeros_like(tgt[..., :1])],
                      dim=2).transpose(1, 2).contiguous()
    eps2 = SOFTENING ** 2
    work = near_flat.lane_items(rows, n_leaves, K11_PACKS)
    got, ms = measure.timed(lambda: near_flat.flat_tune2(
        rows, tgt_t, src, step_packs=K11_PACKS, mode="row", eps2=eps2,
        work=work), iters)
    err = held_rows("K11 flat_tune2 row", got, (rows, tgt_t, src),
                    near_flat.flat_tune2_plain, step_packs=K11_PACKS,
                    mode="row", eps2=eps2)
    pairs = int(valid.sum()) * g * g
    n_bytes = 4 * (src.numel() + 2 * tgt_t.numel() + rows.numel())
    b = measure.pair_bound(pairs, FLOPS_PAIR_POT, n_bytes)
    return {"k11_ms": ms, "k11_pairs": pairs,
            "k11_pairs_per_s": pairs / (ms * 1e-3),
            "k11_bound_ms": b["bound_ms"], "k11_share": b["bound_ms"] / ms,
            "k11_padding_share": 1.0 - live / subs, "k11_max_abs_err": err}


K1_KEYS = ("k1_ms", "k1_pairs", "k1_pairs_per_s", "k1_bound_ms", "k1_share",
           "k1_max_abs_err")
K11_KEYS = ("k11_ms", "k11_pairs", "k11_pairs_per_s", "k11_bound_ms",
            "k11_share", "k11_padding_share", "k11_max_abs_err")


def rates(pos_s, mass_s, near_mask, iters=measure.ITERS, k11=False):
    """K1's rate (and with k11 K11 "row"'s) on the lists of near_mask
    (L, L) over the sorted particles pos_s (L * G, 3), mass_s (L * G,)
    (padding rows of zero mass). On the CPU every value is None."""
    keys = K1_KEYS + (K11_KEYS if k11 else ())
    if pos_s.device.type != "cuda":
        return dict.fromkeys(keys)
    idx, valid = mask_lists(near_mask)
    out = k1_rate(pos_s, mass_s, idx, valid, iters)
    if k11:
        out |= k11_row_rate(pos_s, mass_s, idx, valid, iters)
    return out


def ms_eq(pairs, rate):
    """pairs at rate pairs/s in ms; None without a rate."""
    return None if rate is None else pairs / rate * 1e3
