"""K1's window form on the ring windows of rank 0 of a distributed config,
on one CUDA device: what each window holds, the time of each launch shape
on each window, and one ring evaluation in the window form's designs
against the table form, all on the same lists.

    python3 -m parallelnbody_tpu_torch.tools.k1_windows [--config FILE]
        [--out FILE]

The lists are rank 0's of the config (default
examples/barneshut_distributed_let.json: N = 4M, 8 ranks, leaf 256), built
by parallel/tasks.owned_geometry with the ranks sharing the card. Prints
JSON lines, each with the card's name and power limit as nvidia-smi gives
them; times are ms by CUDA events after a warm-up, compute_pot=False:

  window  one line a window in ring pass order: entries, the longest row,
          rows with an entry, the shape `window_shape` picks, and the ms of
          one launch of each of bh_kernels.WINDOW_SHAPES on it (the first
          pass writes, the others add into the output);
  ring    one ring evaluation (all windows): the window form as shaped
          (`ring_eval`), the 8-entry items at the leaf size's R that write
          and are added by torch (`written_and_added`), in turns, and the
          table form on the LET table, with each one's bound and share.

chip_smoke.py's phase_k1_forms uses `rank0_inputs`, `ring_eval` and
`written_and_added`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.ops import bh_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LET_CONFIG = "examples/barneshut_distributed_let.json"
REPS = 10
WRITTEN_CHUNK = 8       # the window items before they were shaped by window
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
FLOPS_MONOPOLE = 18     # a pair without the potential (chip_smoke.py)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def events_ms(fn, reps=REPS):
    """(last result, mean device ms of reps calls of fn()), CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def rank0_inputs(cfg, device="cuda", timeout=900):
    """Rank 0's inputs of K1's window and table forms for one distributed
    evaluation of cfg (parallel/tasks.owned_geometry on cfg.n_devices
    ranks): targets (L, G, 3), near lists, every rank's owned sources, the
    LET table and its remapped lists, on `device`, and the geometry's
    overflow counts."""
    from parallelnbody_tpu_torch.parallel import mesh, tasks

    outs = mesh.launch(tasks.owned_geometry, cfg.n_devices, cfg.to_json(),
                       None, True, device=device, timeout=timeout)
    r0 = outs[0]

    def on(x):
        return torch.from_numpy(x).to(device)

    return {"tgt": on(r0["tgt"]), "ni": on(r0["near_idx"]),
            "nv": on(r0["near_valid"]), "new_idx": on(r0["let_new_idx"]),
            "table": on(r0["let_table"]),
            "shards": [on(o["sources"]) for o in outs],
            "n_loc": r0["n_leaf_loc"], "refine": r0["refine"],
            "overflow": {k: r0[k] for k in ("of_lists", "of_exchange",
                                            "let_overflow")}}


def ring_order(rank, n_ranks):
    """The windows (owner ranks) of the ring near field in pass order."""
    return [(rank - p) % n_ranks for p in range(n_ranks)]


def window_call(inp, w, cfg, compute_pot=False, fn=bh_kernels.near_field,
                **extra):
    """K1's window form (or, fn=near_field_plain, its plain version) on
    window w (owner rank w's shard) of rank 0's lists."""
    sh = inp["shards"][w]
    return fn(sh[:, :3].contiguous(), sh[:, 3].contiguous(), inp["tgt"],
              inp["ni"], inp["nv"], g=cfg.g, softening=cfg.softening,
              compute_pot=compute_pot, leaf_lo=w * inp["n_loc"], **extra)


def edges(inp, n_ranks):
    return [w * inp["n_loc"] for w in range(n_ranks + 1)]


def ring_works(inp, n_ranks):
    """The ring's shaped items for rank 0 (parallel/distributed.py
    ring_windows): window 0 writes, the others add."""
    return bh_kernels.near_windows(inp["ni"], inp["nv"], edges(inp, n_ranks),
                                   writes=(0,),
                                   leaf_size=inp["tgt"].shape[1])


def ring_eval(inp, works, cfg, compute_pot=False, fn=bh_kernels.near_field):
    """One ring evaluation of rank 0 as parallel/distributed.py _near_ring
    runs it: the windows in pass order, the first written, the others
    added into it in place (works None: the plain version)."""
    out = None
    for w in ring_order(0, len(inp["shards"])):
        extra = {} if works is None else {"work": works[w]}
        out = window_call(inp, w, cfg, compute_pot, fn, out=out, **extra)
    return out


def written_and_added(inp, works, cfg, compute_pot=False):
    """The windows in pass order, each launch writing its own output on
    items that cover every row, added up by torch (the window form before
    it accumulated in place)."""
    acc = pot = None
    for w in ring_order(0, len(inp["shards"])):
        a, p = window_call(inp, w, cfg, compute_pot, work=works[w])
        acc = a if acc is None else acc + a
        pot = p if pot is None else pot + p
    return acc, pot


def k1_bound_ms(inp, n_terms, src_bytes, list_bytes, launches):
    """The least time of n_terms pair terms: FP32 operations over the
    card's rate against the bytes of the sources, targets and lists read
    once and each launch's output written once; (ms, resource)."""
    tgt = inp["tgt"]
    n_slice, leaf, _ = tgt.shape
    n_bytes = (src_bytes + tgt.numel() * 4 + list_bytes
               + launches * n_slice * leaf * 16)
    ops_ms = n_terms * FLOPS_MONOPOLE / FP32_FLOPS * 1e3
    bytes_ms = n_bytes / HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def window_rows(inp, cfg):
    """One record a window in ring pass order: its entries, longest row,
    rows with an entry, the shape window_shape picks, and the ms of a
    launch of each shape of WINDOW_SHAPES (the first pass written, the
    others added into a scratch output)."""
    ni, nv, tgt = inp["ni"], inp["nv"], inp["tgt"]
    n_ranks = len(inp["shards"])
    leaf = tgt.shape[1]
    e = edges(inp, n_ranks)
    bounds = torch.stack([torch.sum(nv & (ni < x), dim=1) for x in e], 1)
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int64)
    n_sm = torch.cuda.get_device_properties(ni.device).multi_processor_count
    scratch = (torch.zeros((tgt.shape[0] * leaf, 3), device=ni.device),
               torch.zeros((tgt.shape[0] * leaf,), device=ni.device))
    for p, w in enumerate(ring_order(0, n_ranks)):
        c = counts[:, w]
        entries, longest = int(c.sum()), int(c.max())
        rec = {"window": w, "pass": p, "entries": entries,
               "longest": longest, "rows": int((c > 0).sum()),
               "pair_terms": entries * leaf * leaf,
               "picked": list(bh_kernels.window_shape(entries, longest,
                                                      leaf, n_sm)),
               "ms": {}, "items": {}}
        for r, chunk in bh_kernels.WINDOW_SHAPES:
            work = bh_kernels.near_items(c, chunk, lo=bounds[:, w], r=r,
                                         every_row=p == 0)
            out = None if p == 0 else scratch

            def once(work=work, out=out):
                return window_call(inp, w, cfg, work=work, out=out)

            once()
            _, ms = events_ms(once)
            rec["ms"][f"{r}x{chunk}"] = ms
            rec["items"][f"{r}x{chunk}"] = int(work.items.shape[0])
        yield rec


def ring_rows(inp, cfg):
    """Ring evaluations of rank 0, shaped and accumulated against written
    and added (in turns: written, shaped, shaped, written), and the table
    form, each with its bound and share."""
    n_ranks = len(inp["shards"])
    leaf = inp["tgt"].shape[1]
    shaped = ring_works(inp, n_ranks)
    written = bh_kernels.near_windows(inp["ni"], inp["nv"],
                                      edges(inp, n_ranks),
                                      chunk=WRITTEN_CHUNK)
    runs = {"shaped": lambda: ring_eval(inp, shaped, cfg),
            "written": lambda: written_and_added(inp, written, cfg)}
    for fn in runs.values():
        fn()
    ms = {k: [] for k in runs}
    for k in ("written", "shaped", "shaped", "written"):
        ms[k].append(events_ms(runs[k])[1])
    n_terms = int(inp["nv"].sum()) * leaf * leaf
    src = sum(s.numel() * 4 for s in inp["shards"])
    lists = inp["ni"].numel() * 4 + inp["nv"].numel()
    b_ring, res = k1_bound_ms(inp, n_terms, src, lists, n_ranks)
    n_rows = inp["table"].shape[0] // leaf
    twork = bh_kernels.near_work(inp["nv"], inp["new_idx"], (0, n_rows))

    def table():
        return bh_kernels.near_field(None, None, inp["tgt"], inp["new_idx"],
                                     inp["nv"], g=cfg.g,
                                     softening=cfg.softening,
                                     compute_pot=False,
                                     src_table=inp["table"], work=twork)

    table()
    _, t_ms = events_ms(table)
    live = inp["nv"] & (inp["new_idx"] < n_rows)
    b_tab, _ = k1_bound_ms(inp, int(live.sum()) * leaf * leaf,
                           inp["table"].numel() * 4, lists, 1)
    yield {"ring": "window form", "pair_terms": n_terms, "bound_ms": b_ring,
           "bound_by": res,
           **{f"{k}_ms": v for k, v in ms.items()},
           **{f"{k}_share": [b_ring / m for m in v] for k, v in ms.items()},
           "shapes": [[w.r, w.chunk, int(w.items.shape[0])] for w in shaped],
           "table_ms": t_ms, "table_bound_ms": b_tab,
           "table_share": b_tab / t_ms}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=LET_CONFIG)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_windows: needs a CUDA device")
    card = _card()
    with open(os.path.join(ROOT, args.config)) as f:
        cfg = SimConfig.from_json(f.read())
    inp = rank0_inputs(cfg)
    if any(inp["overflow"].values()):
        raise SystemExit(f"k1_windows: the lists overflowed: "
                         f"{inp['overflow']}")
    for rec in (*window_rows(inp, cfg), *ring_rows(inp, cfg)):
        line = json.dumps({"card": card, "config": args.config, **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
