"""Where K1's time per list entry goes: the near-field probe of
scripts/near_kernel_probe.py (K8, ops/near_probe.py) on the card, beside K1
on the same lists.

    python3 -m parallelnbody_tpu_torch.tools.near_kernel_probe
        [--n 1048576] [--iters 10] [--rounds 3] [--out FILE]

Inputs are the script's: `init_simulation(SimConfig(n, ic="plummer",
softening=0.01, force="barnes_hut", bh_leaf_size=256, theta=0.72,
bh_near_budget=3584, bh_far_budget=1536))`, then `bh._prepare` (Hilbert
curve), `bh.traverse` and `bh.leaf_interactions` at those arguments (the
near budget capped at the leaf count below N = 1M); it prints the entry
count as the script does.

The table, each row at the script's segment count (4 segments of 1024
rows at N = 1M; F 8 of 512) unless named: A, B, C and E at unroll 4, A at
unroll 8, F (sources 8 floats apart), and A with the whole table as one
segment and in F's 8 segments (which parts F's time into its stride and
its segments). Beside them K1 itself (`bh_kernels.near_field`, compute_pot=False,
its work items built beforehand) on the same lists. Every row that
computes A's function (A, E, unroll 8, F, one segment) is held to K1's
output within rtol 2e-4 / atol 2e-5, and B and C must be finite.

Each row is timed in --rounds rounds: a round times every row by CUDA
events (the mean of --iters calls after a warm-up, whose output is the one
checked; bounds, work items and packed table built beforehand, as the
script builds its bounds outside the timed call),
in table order on even rounds and in reverse on odd ones. A row gives the
median ms and the min and max over the rounds, ns a list entry, pairs/s,
the bound (the live pairs' FP32 operations and rsqrts, or the bytes, at
the H100's published rates) and share = bound / median ms. The last line
answers the script's question round by round: what A - B costs (the list
read), what B - C costs (the read of a new row), each as min, median and
max over the rounds and marked `beyond_spread` only where its median
exceeds the larger min-max spread of its two rows; and E, unroll 8, F,
one segment, 8 segments and K1 against A.

Every line is one JSON object carrying the card's name and power limit as
nvidia-smi gives them (appended to --out). Needs a CUDA device; fails
without one. chip_smoke.py runs `table` and reads its lines.
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh, bh_kernels, near_probe
from parallelnbody_tpu_torch.tools.measure import (ITERS, card, emit,
                                                   max_abs_err, pair_bound,
                                                   rounds_ms, spread)

LEAF, NB, FB, THETA = 256, 3584, 1536, 0.72   # the script's constants
SOFTENING = 0.01                              # eps2 = 1e-4, the script's
N = 1048576
RTOL, ATOL = 2e-4, 2e-5                       # chip_smoke.py's parity bound
FLOPS_PAIR = 18      # K1's pair without the potential (chip_smoke.py)
# (name, mode, unroll, n_comp, segments): the script's segment counts at
# N = 1M, 4096 leaves of 256 (1024 rows a segment; F 512).
VARIANTS = (("A dyn-idx u4", "A", 4, 4, 4),
            ("B seq-row u4", "B", 4, 4, 4),
            ("C row-0 u4", "C", 4, 4, 4),
            ("E tiles-first u4", "E", 4, 4, 4),
            ("A dyn-idx u8", "A", 8, 4, 4),
            ("F 8-comp u4", "A", 4, 8, 8),
            ("A one-segment u4", "A", 4, 4, 1),
            ("A 8-segment u4", "A", 4, 4, 8))
AS_K1 = ("A", "E")   # the modes that compute K1's function


def probe_lists(n=N, device="cuda", leaf=LEAF):
    """The script's lists at n (and leaf, the script's 256 unless a test
    names a smaller one): a dict of the sorted particles (pos_s, mass_s),
    the target leaves as K1 takes them (tgt (L, G, 3)) and as the probe
    does (tgt_t (L, 4, G), 4th row 0), the source table (L, 4, G),
    idx / valid and the live entry count."""
    cfg = SimConfig(n=n, ic="plummer", softening=SOFTENING,
                    force="barnes_hut", bh_leaf_size=leaf, theta=THETA,
                    bh_near_budget=NB, bh_far_budget=FB)
    st = init_simulation(cfg, device, compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        st.pos, st.mass, leaf_size=leaf, curve="hilbert")
    n_leaves = n_pad // leaf
    _, rej = bh.traverse(tree, THETA)
    idx, valid, _, _, _ = bh.leaf_interactions(
        tree, rej, THETA, start_leaf=0, n_slice=n_leaves,
        near_budget=min(NB, n_leaves), far0_budget=min(FB, n_leaves))
    tgt = pos_s.reshape(n_leaves, leaf, 3)
    table = torch.cat([tgt, mass_s.reshape(n_leaves, leaf, 1)], dim=2)
    return dict(pos_s=pos_s, mass_s=mass_s, tgt=tgt,
                tgt_t=torch.cat([tgt, torch.zeros_like(tgt[..., :1])],
                                dim=2).transpose(1, 2).contiguous(),
                table=table.transpose(1, 2).contiguous(),
                idx=idx.to(torch.int32).contiguous(), valid=valid,
                entries=int(valid.sum()))


def work(L, n_comp):
    """What one call needs: the live pairs' operations and rsqrts, and the
    bytes of its inputs and output moved once (targets, the packed table,
    the live list entries, the bounds, the output)."""
    n_leaves, _, g = L["tgt_t"].shape
    n_bytes = (2 * n_leaves * 4 * g * 4 + n_leaves * g * n_comp * 4
               + L["entries"] * 4 + n_leaves * 8)
    return pair_bound(L["entries"] * g * g, FLOPS_PAIR, n_bytes)


def k1_acc(L, work_items):
    """K1's acceleration sums (L, 3, G) on the lists (g = 1, no
    potential), the probe's layout."""
    acc, _ = bh_kernels.near_field(
        L["pos_s"], L["mass_s"], L["tgt"], L["idx"], L["valid"], g=1.0,
        softening=SOFTENING, compute_pot=False, work=work_items)
    n_leaves, g, _ = L["tgt"].shape
    return acc.reshape(n_leaves, g, 3).transpose(1, 2)


def _diff(times, x, y):
    """x - y round by round: min, median and max, and whether the median
    exceeds the larger min-max spread of the two rows."""
    d = spread([a - b for a, b in zip(times[x], times[y])])
    wide = max(max(times[v]) - min(times[v]) for v in (x, y))
    return {"min": d["ms_min"], "median": d["ms"], "max": d["ms_max"],
            "spread": wide, "beyond_spread": abs(d["ms"]) > wide}


def table(n=N, iters=ITERS, out=None, lists=None, rounds=1):
    """Runs every variant and K1 on the lists at n (or `lists`, from
    probe_lists) in `rounds` rounds; prints and returns the records, the
    answer last."""
    if not torch.cuda.is_available():
        raise RuntimeError("near_kernel_probe measures the card: "
                           "torch.cuda.is_available() is False")
    smi = card()
    L = lists or probe_lists(n, torch.device("cuda"))
    n_leaves, _, g = L["tgt_t"].shape
    entries = L["entries"]
    print(f"entries: {entries} ({entries / n_leaves:.1f}/target)",
          flush=True)
    items = bh_kernels.near_work(L["valid"])
    base = {"tool": "near_kernel_probe", "n": n, "leaf": g,
            "leaves": n_leaves, "entries": entries, "rounds": rounds,
            "card": smi}
    calls, recs = {}, {}
    for name, mode, unroll, n_comp, n_seg in VARIANTS:
        rows = n_leaves // n_seg
        bnd = near_probe.probe_bounds(L["idx"], L["valid"], rows)
        calls[name] = functools.partial(
            near_probe.near_probe, L["tgt_t"], L["table"], L["idx"],
            L["valid"], mode=mode, unroll=unroll, rows_per_seg=rows,
            n_comp=n_comp, bnd=bnd, items=near_probe.probe_items(bnd),
            packed=near_probe.probe_table(L["table"], n_comp))
        recs[name] = {"variant": name, "mode": mode, "unroll": unroll,
                      "n_comp": n_comp, "segments": n_seg,
                      "rows_per_seg": rows, **work(L, n_comp)}
    calls["K1 near_field"] = lambda: k1_acc(L, items)
    recs["K1 near_field"] = {"variant": "K1 near_field", **work(L, 4)}
    times, firsts = rounds_ms(calls, rounds, iters)
    want = firsts.pop("K1 near_field")
    torch.cuda.synchronize()
    for name, got in firsts.items():
        if recs[name]["mode"] in AS_K1:
            recs[name]["max_abs_err_vs_k1"] = max_abs_err(
                f"{name} against K1", got[:, :3], want, RTOL, ATOL)
        elif not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite output")
        else:
            recs[name]["max_abs_err_vs_k1"] = None
    del firsts, want
    k1_ms = spread(times["K1 near_field"])["ms"]
    records = []
    for name, rec in recs.items():
        rec = {**base, **rec, **spread(times[name]),
               "ms_rounds": times[name]}
        rec.update({"ns_per_entry": rec["ms"] * 1e6 / entries,
                    "pairs_per_s": entries * g * g / (rec["ms"] * 1e-3),
                    "share": rec["bound_ms"] / rec["ms"]})
        if "max_abs_err_vs_k1" in rec:
            rec["k1_ms"] = k1_ms
        emit(rec, out)
        records.append(rec)
    by = {r["variant"]: r for r in records}
    a = by["A dyn-idx u4"]["ms"]
    ans = {**base, "answer": True,
           "list_read_ms": _diff(times, "A dyn-idx u4", "B seq-row u4"),
           "new_row_read_ms": _diff(times, "B seq-row u4", "C row-0 u4"),
           "k1_ms": k1_ms, "A_ms": a,
           **{f"{v}_over_A": by[v]["ms"] / a
              for v in ("E tiles-first u4", "A dyn-idx u8", "F 8-comp u4",
                        "A one-segment u4", "A 8-segment u4",
                        "K1 near_field")}}
    for key in ("list_read", "new_row_read"):
        ans[f"{key}_ns_per_entry"] = ans[f"{key}_ms"]["median"] * 1e6 / entries
    emit(ans, out)
    records.append(ans)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("near_kernel_probe: torch.cuda.is_available() is False; "
                 "this tool measures the card")
    table(opts.n, opts.iters, opts.out, rounds=opts.rounds)


if __name__ == "__main__":
    main()
