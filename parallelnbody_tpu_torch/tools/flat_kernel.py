"""The flat-list near-field experiments of scripts/flat_kernel_proto.py,
flat_kernel_tune.py and flat_kernel_tune2.py (K9, K10, K11 of
ops/near_flat.py) on the card, and against K1 on K1's own lists.

    python3 -m parallelnbody_tpu_torch.tools.flat_kernel SUBCOMMAND
        [--iters 10] [--n 1048576] [--rounds 3] [--out FILE]

Subcommands (each draws the script's inputs with the script's own
numpy.random.default_rng(0) calls, in the script's order):

  proto   flat_kernel_proto.py: `correctness()` (5 rows, 1-4 steps each,
          eps2 1e-2) held against the plain version (relative error below
          1e-5, the script's check), then `bench()` (4096 rows, 56320
          steps of 4 packs, G 256), timed;
  tune    flat_kernel_tune.py `main()`: step packs 4, 8, 16 x out_mode
          "rmw" / "steps" (the two must give the same bits);
  tune2   flat_kernel_tune2.py `main()`: the "step" / "row" check at 64
          rows for step packs 4, 8, 16 (both against the plain version and
          within 1e-3 of each other, the script's check), then step packs
          8, 16 x "step" / "row", timed (K11's work items built
          beforehand, `near_flat.lane_items`);
  lists   K1's near lists at --n (the lists of tools/near_kernel_probe.py,
          N = 1M: leaf 256, theta 0.72) cut into the flat form
          (`near_flat.pack_lists`: the same pairs K1 evaluates, rows padded
          with zero-mass sources to whole steps): K9, then K10 and K11 at
          step packs 4, 8, 16 (K1's and K11's work items built
          beforehand), each held to K1's output (compute_pot, eps
          0.01; rtol 2e-4 / atol 2e-5) and timed beside K1 in --rounds
          rounds, in table order on even rounds and in reverse on odd
          ones; the packing's own time and bytes are printed apart.

Each launch of proto, tune and tune2 at the scripts' bench sizes is held
against its plain version on SAMPLE_ROWS target rows spread over the
table, the first and the last among them (`sample_rows`: those rows'
steps and targets, a problem of their own; rtol 2e-4 of each row's
largest |value| plus atol 2e-5, as the scripts' random sources cancel
some sums to near zero).

Each variant prints one JSON line: ms (CUDA events, the mean of --iters
after a warm-up; for lists the median over the rounds, with their min and
max), pairs/s, the bound (FP32 operations of the pairs the
data needs, 19 a pair with the potential, and one rsqrt each, or the
bytes, at the H100's published rates) and share = bound / ms, the steps,
the padding share, and the card's name and power limit as nvidia-smi gives
them (appended to --out). Needs a CUDA device; fails without one.
chip_smoke.py runs each subcommand's function and reads its lines.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from parallelnbody_tpu_torch.ops import bh_kernels, near_flat
from parallelnbody_tpu_torch.tools import near_kernel_probe as probe
from parallelnbody_tpu_torch.tools.measure import (ITERS, card, emit,
                                                   events_ms, max_abs_err,
                                                   pair_bound, rounds_ms,
                                                   rows_close, spread, timed)

G = 256                    # the scripts' g
N_ROWS = 4096              # the scripts' n_rows at N = 1M
PROTO_STEPS = 56320        # flat_kernel_proto.py bench
MEAN_SUBS = 204            # the tune scripts' poisson mean
SCRIPT_EPS2 = 1e-2
RTOL, ATOL = probe.RTOL, probe.ATOL
PROTO_REL = 1e-5           # flat_kernel_proto.py correctness
TUNE2_DIFF = 1e-3          # flat_kernel_tune2.py step-vs-row check
FLOPS_PAIR = 19            # K1's pair (18) and the potential's add
SAMPLE_ROWS = 32           # rows of a bench launch held to the plain version


def _dev():
    if not torch.cuda.is_available():
        raise RuntimeError("flat_kernel measures the card: "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _record(sub, kernel, variant, ms, rows, tgt_t, src, smi, pairs=None,
            **extra):
    """One line: ms, pairs/s, bound and share for a call on (rows, tgt_t,
    src). pairs: the pairs the data needs (default every source of src
    against its row's G targets)."""
    n_steps, packs = src.shape[:2]
    g = tgt_t.shape[2]
    evaluated = n_steps * packs * near_flat.LANES * g
    pairs = evaluated if pairs is None else pairs
    n_bytes = 4 * (src.numel() + 2 * tgt_t.numel() + rows.numel()
                   + tgt_t.shape[0] + 1)
    rec = {"tool": "flat_kernel", "sub": sub, "kernel": kernel,
           "variant": variant, "ms": ms, "steps": n_steps,
           "step_packs": packs, "rows": tgt_t.shape[0], "leaf": g,
           "evaluated_pairs": evaluated,
           "pairs_per_s": pairs / (ms * 1e-3),
           **pair_bound(pairs, FLOPS_PAIR, n_bytes),
           **extra, "card": smi}
    rec["share"] = rec["bound_ms"] / ms
    return rec


def sample_rows(rows, tgt_t, src, n_sample=SAMPLE_ROWS):
    """n_sample target rows spread evenly over tgt_t, the first and the
    last among them, as a problem of their own: (picked (k,) row ids,
    (rows', tgt_t', src')) with those rows' steps in order, renumbered
    0..k-1. A row's sums depend only on its targets and its steps, so the
    plain version on it gives the full problem's rows `picked`."""
    n_rows = tgt_t.shape[0]
    picked = torch.unique(torch.linspace(0, n_rows - 1, n_sample).round()
                          .long()).to(rows.device)
    keep = torch.isin(rows.long(), picked)
    sub_rows = torch.searchsorted(picked, rows[keep].long()).to(torch.int32)
    return picked, (sub_rows, tgt_t[picked].contiguous(),
                    src[keep].contiguous())


def held_rows(label, got, args, plain, **kw):
    """max |got - plain| on sample_rows of args (rows, tgt_t, src); raises
    beyond the row-scale bound."""
    picked, sub = sample_rows(*args)
    return rows_close(label, got[picked], plain(*sub, **kw), RTOL, ATOL)


def _rel_err(got, want):
    """max |got - want| / max |want| (the scripts' measure)."""
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _steps_rows(rng, n_rows, mean, step_packs):
    """The tune scripts' rows: poisson(mean) sub-tiles a row (at least 1),
    padded to whole steps of step_packs * 4."""
    counts = np.maximum(1, rng.poisson(mean, n_rows))
    spr = -(-counts // (step_packs * near_flat.PACK_SUBS))
    return np.repeat(np.arange(n_rows), spr).astype(np.int32)


def proto_check_inputs(dev):
    """flat_kernel_proto.py correctness()'s inputs (rows, tgt_t, src) on
    dev: 5 rows of 1-4 steps, G 256, masses made positive as it makes
    them."""
    rng = np.random.default_rng(0)
    n_rows, g = 5, 256
    rows = np.repeat(np.arange(n_rows), [1, 3, 2, 1, 4]).astype(np.int32)
    tgt_t = rng.normal(size=(n_rows, 4, g)).astype(np.float32)
    src = rng.normal(size=(rows.shape[0], near_flat.PROTO_PACKS, 4,
                           near_flat.LANES)).astype(np.float32)
    src[:, :, 3] = np.abs(src[:, :, 3])
    return _t(rows, dev), _t(tgt_t, dev), _t(src, dev)


def tune2_check_inputs(rng, dev):
    """flat_kernel_tune2.py main()'s check inputs, drawn from rng (its
    default_rng(0), which main() then goes on drawing from): [(step packs,
    (rows, tgt_t, src))] at 4, 8, 16 packs, 64 rows of poisson(6)
    sub-tiles, G 256."""
    counts = np.maximum(1, rng.poisson(6, 64))
    out = []
    for packs in near_flat.STEP_PACKS:
        spr = -(-counts // (packs * near_flat.PACK_SUBS))
        rows = np.repeat(np.arange(64), spr).astype(np.int32)
        tgt = rng.normal(size=(64, 4, G)).astype(np.float32)
        src = rng.normal(size=(rows.shape[0], packs, 4,
                               near_flat.LANES)).astype(np.float32)
        out.append((packs, (_t(rows, dev), _t(tgt, dev), _t(src, dev))))
    return out


def proto(iters=ITERS, out=None):
    dev, smi = _dev(), card()
    args = proto_check_inputs(dev)
    got = near_flat.flat_near(*args, eps2=SCRIPT_EPS2)
    err = _rel_err(got, near_flat.flat_near_plain(*args, eps2=SCRIPT_EPS2))
    if not err < PROTO_REL:
        raise AssertionError(f"proto correctness: rel err {err:.2e}")
    records = [{"tool": "flat_kernel", "sub": "proto", "kernel": "flat_near",
                "variant": "correctness", "rel_err_vs_plain": err,
                "card": smi}]
    emit(records[-1], out)
    rng = np.random.default_rng(0)
    n_rows, g = N_ROWS, G
    rows = np.sort(rng.integers(0, n_rows, PROTO_STEPS - n_rows)).astype(
        np.int32)
    rows = np.sort(np.concatenate([rows, np.arange(n_rows, dtype=np.int32)]))
    tgt_t = rng.normal(size=(n_rows, 4, g)).astype(np.float32)
    src = rng.normal(size=(PROTO_STEPS, near_flat.PROTO_PACKS, 4,
                           near_flat.LANES)).astype(np.float32)
    args = (_t(rows, dev), _t(tgt_t, dev), _t(src, dev))
    del src
    got, ms = timed(lambda: near_flat.flat_near(*args, eps2=SCRIPT_EPS2),
                    iters)
    err = held_rows("proto bench", got, args, near_flat.flat_near_plain,
                    eps2=SCRIPT_EPS2)
    records.append(_record("proto", "flat_near", "bench P=4", ms, *args,
                           smi, max_abs_err_vs_plain=err))
    emit(records[-1], out)
    return records


def tune(iters=ITERS, out=None):
    dev, smi = _dev(), card()
    rng = np.random.default_rng(0)
    records = []
    for packs in near_flat.STEP_PACKS:
        rows = _steps_rows(rng, N_ROWS, MEAN_SUBS, packs)
        tgt_t = rng.normal(size=(N_ROWS, 4, G)).astype(np.float32)
        src = rng.normal(size=(rows.shape[0], packs, 4,
                               near_flat.LANES)).astype(np.float32)
        args = (_t(rows, dev), _t(tgt_t, dev), _t(src, dev))
        del src
        outs = {}
        for mode in near_flat.OUT_MODES:
            def call(mode=mode):
                return near_flat.flat_tune(*args, step_packs=packs,
                                           out_mode=mode)
            outs[mode], ms = timed(call, iters)
            err = held_rows(f"tune P={packs} {mode}", outs[mode], args,
                            near_flat.flat_tune_plain, step_packs=packs,
                            out_mode=mode)
            records.append(_record("tune", "flat_tune", f"P={packs} {mode}",
                                   ms, *args, smi, max_abs_err_vs_plain=err))
            emit(records[-1], out)
        if not torch.equal(outs["rmw"], outs["steps"]):
            raise AssertionError(f"tune P={packs}: rmw and steps differ")
        del args, outs
    return records


def tune2(iters=ITERS, out=None):
    dev, smi = _dev(), card()
    rng = np.random.default_rng(0)
    records = []
    for packs, args in tune2_check_inputs(rng, dev):
        outs = {m: near_flat.flat_tune2(*args, step_packs=packs, mode=m)
                for m in near_flat.LANE_MODES}
        diff = float((outs["step"] - outs["row"]).abs().max())
        errs = {m: _rel_err(outs[m], near_flat.flat_tune2_plain(
            *args, step_packs=packs, mode=m)) for m in near_flat.LANE_MODES}
        if not diff < TUNE2_DIFF or max(errs.values()) >= PROTO_REL:
            raise AssertionError(f"tune2 P={packs}: step-vs-row {diff:.2e}, "
                                 f"against plain {errs}")
        records.append({"tool": "flat_kernel", "sub": "tune2",
                        "kernel": "flat_tune2", "variant": f"check P={packs}",
                        "step_vs_row_max_diff": diff,
                        "rel_err_vs_plain": errs, "card": smi})
        emit(records[-1], out)
    for packs in (8, 16):
        rows = _steps_rows(rng, N_ROWS, MEAN_SUBS, packs)
        tgt_t = rng.normal(size=(N_ROWS, 4, G)).astype(np.float32)
        src = rng.normal(size=(rows.shape[0], packs, 4,
                               near_flat.LANES)).astype(np.float32)
        args = (_t(rows, dev), _t(tgt_t, dev), _t(src, dev))
        del src
        work = near_flat.lane_items(args[0], N_ROWS, packs)
        for mode in near_flat.LANE_MODES:
            def call(mode=mode):
                return near_flat.flat_tune2(*args, step_packs=packs,
                                            mode=mode, work=work)
            got, ms = timed(call, iters)
            err = held_rows(f"tune2 P={packs} {mode}", got, args,
                            near_flat.flat_tune2_plain, step_packs=packs,
                            mode=mode)
            records.append(_record("tune2", "flat_tune2",
                                   f"P={packs} {mode}", ms, *args, smi,
                                   max_abs_err_vs_plain=err))
            emit(records[-1], out)
        del args
    return records


def lists(n=probe.N, iters=ITERS, out=None, L=None, rounds=1):
    """K9-K11 on K1's lists (`L` from near_kernel_probe.probe_lists, or
    built here at n), each held to K1 and timed beside it in `rounds`
    rounds."""
    dev, smi = _dev(), card()
    L = L or probe.probe_lists(n, dev)
    n_leaves, g, _ = L["tgt"].shape
    eps2 = probe.SOFTENING ** 2
    items = bh_kernels.near_work(L["valid"])

    def k1():
        return bh_kernels.near_field(
            L["pos_s"], L["mass_s"], L["tgt"], L["idx"], L["valid"], g=1.0,
            softening=probe.SOFTENING, compute_pot=True, work=items)

    live_pairs = L["entries"] * g * g
    tgt_t = L["tgt_t"]
    src_leaves = L["table"].transpose(1, 2)      # (L, G, 4)
    calls, recs = {"K1 near_field": k1}, {}
    for packs in near_flat.STEP_PACKS:
        rows, src, live, subs = near_flat.pack_lists(src_leaves, L["idx"],
                                                     L["valid"], packs)
        pack_ms = events_ms(lambda: near_flat.pack_lists(
            src_leaves, L["idx"], L["valid"], packs), 1)
        extra = {"pack_ms": pack_ms, "src_bytes": src.numel() * 4,
                 "padding_share": 1.0 - live / subs, "n": n,
                 "entries": L["entries"], "rounds": rounds}
        fa = (rows, tgt_t, src)
        variants = [("flat_tune", f"P={packs} {m}", functools.partial(
            near_flat.flat_tune, *fa, step_packs=packs, out_mode=m,
            eps2=eps2)) for m in near_flat.OUT_MODES]
        work = near_flat.lane_items(rows, n_leaves, packs)
        variants += [("flat_tune2", f"P={packs} {m}", functools.partial(
            near_flat.flat_tune2, *fa, step_packs=packs, mode=m, eps2=eps2,
            work=work)) for m in near_flat.LANE_MODES]
        if packs == near_flat.PROTO_PACKS:
            variants.insert(0, ("flat_near", "P=4", functools.partial(
                near_flat.flat_near, *fa, eps2=eps2)))
        for kernel, variant, call in variants:
            calls[(kernel, variant)] = call
            recs[(kernel, variant)] = (fa, dict(extra))
    times, firsts = rounds_ms(calls, rounds, iters)
    acc, pot = firsts.pop("K1 near_field")
    want = torch.cat([acc.reshape(n_leaves, g, 3),
                      -pot.reshape(n_leaves, g, 1)], dim=2).transpose(1, 2)
    torch.cuda.synchronize()
    for key, got in firsts.items():
        recs[key][1]["max_abs_err_vs_k1"] = max_abs_err(
            f"lists {key[0]} {key[1]} against K1", got, want, RTOL, ATOL)
    del firsts, want, acc, pot
    k1_ms = spread(times["K1 near_field"])
    emit({"tool": "flat_kernel", "sub": "lists", "kernel": "near_field",
          "variant": "K1 near_field", **k1_ms,
          "ms_rounds": times["K1 near_field"], "rounds": rounds,
          "card": smi}, out)
    records = []
    for key, (fa, extra) in recs.items():
        ms = spread(times[key])
        records.append(_record("lists", *key, ms["ms"], *fa, smi,
                               pairs=live_pairs, ms_min=ms["ms_min"],
                               ms_max=ms["ms_max"], ms_rounds=times[key],
                               k1_ms=k1_ms["ms"], **extra))
        emit(records[-1], out)
    return records


SUBCOMMANDS = {"proto": proto, "tune": tune, "tune2": tune2, "lists": lists}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("subcommand", choices=sorted(SUBCOMMANDS))
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--n", type=int, default=probe.N,
                    help="N of K1's lists (lists only)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed rounds (lists only)")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flat_kernel: torch.cuda.is_available() is False; this "
                 "tool measures the card")
    if opts.subcommand == "lists":
        lists(opts.n, opts.iters, opts.out, rounds=opts.rounds)
    else:
        SUBCOMMANDS[opts.subcommand](opts.iters, opts.out)


if __name__ == "__main__":
    main()
