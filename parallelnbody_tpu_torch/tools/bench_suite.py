"""The benchmark suite on one CUDA device: the port of
scripts/bench_suite.py. It measures every BASELINE config that fits one
card and writes a markdown table; each row is also one JSON line on
standard output.

    python3 -m parallelnbody_tpu_torch.tools.bench_suite [--quick] [--xl]
        [--no-reuse] [--filter TEXT] [--out build/bench_results_torch.md]
        [--device cuda] [--ranks P]

Cases. On the card the script's full list: all-pairs (K3,
force="direct_pallas") at N = 65536 and 262144; Barnes-Hut at N = 262144,
1M, the 2M galaxy collision, 4M and 8M; `--xl` adds 16M and 32M. `--quick`,
or `--device cpu` (the tests), gives the script's two quick cases. Every
config leaves `bh_leaf_size` and the budgets at auto, so each row runs the
device's own leaf rule and `prepare_simulation`'s calibration (on the card
also one step on); each row prints the leaf, refinement and sections it
resolved to.

Each row (`measure_step`, the script's `measure`): `prepare_simulation`,
one step, then ITERS timed steps of `make_step`. It reports ms/step on the
host clock (the loop ends in a synchronize) and by CUDA events, steps/s,
pairs/s (all-pairs rows), the device's busy share of a step
(torch.profiler, `measure.busy_ms`; None where no reading was whole), the
peak device memory of the row (read before the rms sample, whose
direct-sum temporaries, ~4 GiB at k = 4096, are not the run's), the
seconds of prepare plus the first step (`init_plus_first_s`: the card
compiles nothing, the kernels are built at first use and ICs and
calibration dominate), and the kernel launches of the timed steps.
Barnes-Hut rows add the sampled rms force error of the last step's forces
(`rms_force_error_sample`, k = 4096), the overflow summed over every step
(device scalars, read once after the loop) and the calibrated budgets.

Rebuild rows (`measure_reuse`, unless `--no-reuse`): each Barnes-Hut case
through `make_run` at `bh_rebuild_every` = 8 over 16 steps, timed on a
second call from the same state; rms and overflow of that run; the busy
share that of one block of 8 steps (a profiled session over the whole run
can lose records at 4M and above). The
script's `_REUSE_MAX_ROWS` gate is a TPU runtime's and the port has none
(`api._reuse_eligible`), so every Barnes-Hut row is eligible.

The sharded row (`measure_sharded`): all-pairs at N = 262144 (K3) over
one rank a card where the machine has more than one card; on one card it
is skipped, as the script skips it on one chip. `--ranks P --device cpu`
runs it over P CPU ranks at N = 4096 (force="direct") for the tests.

A row that raises is printed and tabled with its error (its traceback on
standard error), the suite goes on, and `main` then exits non-zero: no
failure is hidden in the table. `--out` defaults under build/ (git
ignores it; a `--filter` run writes build/bench_filtered_torch.md unless
`--out` is given). `--device cpu` runs the plain versions and times
nothing on a device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import (_reuse_eligible, make_run,
                                         make_step, prepare_simulation)
from parallelnbody_tpu_torch.ops import bh, bh_kernels, direct_kernels
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

ITERS = 5                      # timed steps a row
REUSE_K, REUSE_STEPS = 8, 16   # the rebuild rows' interval and run length
DEFAULT_OUT = os.path.join("build", "bench_results_torch.md")
FILTERED_OUT = os.path.join("build", "bench_filtered_torch.md")
GIB = 2**30
COMMON = dict(ic="plummer", integrator="leapfrog", softening=0.01, dt=1e-4)


def quick_cases():
    return [
        ("all-pairs n=4096", SimConfig(n=4096, force="direct", **COMMON)),
        ("BH n=16384", SimConfig(n=16384, force="barnes_hut", theta=0.7,
                                 bh_leaf_size=64, **COMMON)),
    ]


def full_cases(xl=False):
    """The script's list: theta 0.72 with quadrupoles and no potential in
    the hot step; leaf and budgets auto."""
    bh_kw = dict(force="barnes_hut", theta=0.72, track_potential=False)
    cases = [
        ("all-pairs n=65536", SimConfig(
            n=65536, force="direct_pallas", track_potential=False,
            **COMMON)),
        ("all-pairs n=262144 (BASELINE config 2)", SimConfig(
            n=262144, force="direct_pallas", track_potential=False,
            **COMMON)),
        ("Barnes-Hut n=262144", SimConfig(n=262144, **bh_kw, **COMMON)),
        ("Barnes-Hut n=1048576 (BASELINE config 3)",
         SimConfig(n=1048576, **bh_kw, **COMMON)),
        ("Barnes-Hut n=2097152 galaxy collision (BASELINE config 5)",
         SimConfig(n=2097152, ic="galaxy_collision", integrator="leapfrog",
                   softening=0.01, dt=5e-4, **bh_kw)),
        ("Barnes-Hut n=4194304", SimConfig(n=4194304, **bh_kw, **COMMON)),
        ("Barnes-Hut n=8388608", SimConfig(n=8388608, **bh_kw, **COMMON)),
    ]
    if xl:
        cases += [
            ("Barnes-Hut n=16777216", SimConfig(n=16777216, **bh_kw,
                                                **COMMON)),
            ("Barnes-Hut n=33554432 (sections auto)",
             SimConfig(n=33554432, **bh_kw, **COMMON)),
        ]
    return cases


def _launches():
    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}


def _launched(before):
    after = _launches()
    return {k: after[k] - before[k] for k in after if after[k] > before[k]}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _start_row(dev):
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return time.perf_counter()


def _peak_gib(dev):
    return (torch.cuda.max_memory_allocated(dev) / GIB
            if dev.type == "cuda" else None)


def _timed(fn, n_calls, dev):
    """(the last output, host ms, events ms) of n_calls calls of fn(),
    each ms the total; events None off the card."""
    ev = None
    if dev.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    out = None
    for _ in range(n_calls):
        out = fn(out)
    if ev is not None:
        ev[1].record()
    _sync(dev)
    host = (time.perf_counter() - t0) * 1e3
    return out, host, (ev[0].elapsed_time(ev[1]) if ev else None)


def _geometry(cfg, dev):
    """The leaf, refinement and sections the config resolves to on dev."""
    if cfg.resolve_force(dev) != "barnes_hut":
        return {}
    setup = bh.BHSetup.of(cfg.with_resolved_leaf(dev))
    return {"leaf": setup.leaf, "refine": setup.refine,
            "sections": setup.sections}


def _budgets(cfg):
    return {"near": cfg.bh_near_budget, "far": cfg.bh_far_budget,
            "cand2": cfg.bh_cand2_budget, "cand1": cfg.bh_cand_budget}


def _busy(fn, dev, ms):
    if dev.type != "cuda":
        return {"busy_ms": None, "busy_share": None}
    busy = measure.busy_ms(fn)
    return {"busy_ms": busy,
            "busy_share": None if busy is None else busy / ms}


def measure_step(cfg: SimConfig, dev, iters: int = ITERS, state=None):
    """One row: prepare, a first step, iters timed steps of make_step.
    `state`, where given, holds the initial conditions (the tests' JAX
    ICs); else the config's own."""
    bh_row = cfg.resolve_force(dev) == "barnes_hut"
    t0 = _start_row(dev)
    cfg, state = prepare_simulation(cfg, dev, state=state)
    step = make_step(cfg, report_overflow=True)
    state, of_first = step(state)
    _sync(dev)
    t_init = time.perf_counter() - t0
    ofs = [of_first]

    def one(_):
        nonlocal state
        state, of = step(state)
        ofs.append(of)   # a device scalar: no host read inside the loop
        return state

    before = _launches()
    _, host, events = _timed(one, iters, dev)
    launches = _launched(before)
    ms = host / iters
    row = {"n": cfg.n, "force": cfg.resolve_force(dev), **_geometry(cfg, dev),
           "ms_per_step": ms,
           "events_ms_per_step": None if events is None else events / iters,
           "steps_per_sec": 1e3 / ms, "init_plus_first_s": t_init,
           "launches": launches}
    row.update(_busy(lambda: step(state), dev,
                     row["events_ms_per_step"] or ms))
    # The run's peak, read before the rms sample's direct-sum temporaries.
    row["peak_gib"] = _peak_gib(dev)
    if not bh_row:
        row["pairs_per_sec"] = cfg.n * cfg.n / (ms / 1e3)
    else:
        # The forces of the last benchmarked step, consistent with its
        # positions after a KDK step.
        row["rms_force_error"] = rms_force_error_sample(
            state.pos, state.mass, state.acc, g=cfg.g,
            softening=cfg.softening)
        row["overflow"] = int(torch.stack(ofs).sum())
        row["budgets"] = _budgets(cfg)
    return row


def measure_reuse(cfg: SimConfig, dev, k: int = REUSE_K,
                  n_steps: int = REUSE_STEPS, state=None):
    """The same config through make_run at bh_rebuild_every = k: one sort,
    traversal and list build a block of k steps, the pyramid refreshed
    every step. Timed on a second call from the prepared state; rms on the
    final state's own forces, overflow over that call's n_steps steps."""
    cfg = cfg.replace(bh_rebuild_every=k)
    if not _reuse_eligible(cfg.with_resolved_leaf(dev), n_steps, dev):
        raise ValueError("config not eligible for bh_rebuild_every")
    t0 = _start_row(dev)
    cfg, state = prepare_simulation(cfg, dev, state=state)
    run = make_run(cfg, n_steps, report_overflow=True)
    run(state)
    _sync(dev)
    t_init = time.perf_counter() - t0
    before = _launches()
    (out, of), host, events = _timed(lambda _: run(state), 1, dev)
    launches = _launched(before)
    ms = host / n_steps
    # The busy share of one block of k steps (the same program a block):
    # a profiled session over the whole run can lose records at 4M+.
    block = make_run(cfg, k, report_overflow=True)
    block(state)
    _, block_host, block_events = _timed(lambda _: block(state), 1, dev)
    busy = _busy(lambda: block(state), dev, block_events or block_host)
    return {"n": cfg.n, "force": cfg.resolve_force(dev),
            **_geometry(cfg, dev), "rebuild_every": k, "ms_per_step": ms,
            "events_ms_per_step": (None if events is None
                                   else events / n_steps),
            "steps_per_sec": 1e3 / ms, "init_plus_first_s": t_init,
            "launches": launches, "overflow": int(of),
            "busy_share": busy["busy_share"],
            "busy_ms": (None if busy["busy_ms"] is None
                        else busy["busy_ms"] / k),
            # The run's peak, read before the rms sample's temporaries.
            "peak_gib": _peak_gib(dev),
            "rms_force_error": rms_force_error_sample(
                out.pos, out.mass, out.acc, g=cfg.g, softening=cfg.softening),
            "budgets": _budgets(cfg)}


def _sharded_task(group, cfg_json, iters):
    """Rank program of measure_sharded: the rank's shard of the config's
    ICs, t = 0 forces, one step, then iters timed steps (host clock, the
    loop ending in a synchronize). Returns ms a step."""
    from parallelnbody_tpu_torch.parallel import sharded, tasks

    cfg = SimConfig.from_json(cfg_json)
    state = sharded.sharded_init_accel(
        cfg, group, tasks.local_state(group, cfg, None))
    step = sharded.make_sharded_step(cfg, group)
    state = step(state)
    _sync(group.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    _sync(group.device)
    return (time.perf_counter() - t0) * 1e3 / iters


def measure_sharded(cfg: SimConfig, n_ranks: int, dev, iters: int = ITERS):
    """The sharded step over n_ranks ranks in one ring (one rank a card on
    CUDA, which needs n_ranks cards; gloo ranks on the CPU)."""
    from parallelnbody_tpu_torch.parallel import RankPool

    with RankPool(n_ranks, dev) as pool:
        ms = pool.run(_sharded_task, cfg.to_json(), iters)[0]
    force = cfg.resolve_force(dev)
    return {"n": cfg.n, "force": force, "devices": n_ranks,
            "ms_per_step": ms, "steps_per_sec": 1e3 / ms,
            "pairs_per_sec_per_device": (cfg.n * cfg.n / (ms / 1e3) / n_ranks
                                         if force != "barnes_hut" else None)}


def _cell(v, fmt):
    return "-" if v is None else format(v, fmt)


def table(rows, card):
    lines = [
        "# Benchmark results (parallelnbody_tpu_torch)",
        "",
        f"Card: {card}; generated by "
        "`python3 -m parallelnbody_tpu_torch.tools.bench_suite`.",
        "",
        "ms/step: host clock over the timed steps (the loop ends in a "
        "synchronize), events: CUDA events over the same steps. busy: the "
        "device's busy share of one step (torch.profiler; - where no "
        "reading was whole). rms: relative rms force error of the last "
        "step's forces against a direct sum over 4096 sampled targets "
        "(all-pairs rows are exact). overflow: list clips summed over every "
        "timed step; anything but 0 is a different result. Every "
        "Barnes-Hut budget is calibrated from the row's own t = 0 state "
        "(and one step on, on the card). peak: max_memory_allocated over "
        "the row. init+first: ICs, calibration, t = 0 forces and the "
        "first step (the kernels are built at first use, not per row).",
        "",
        "| Case | ms/step | events ms | steps/s | pairs/s | busy | rms | "
        "overflow | peak GiB | init+first s | leaf / refine / sections |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['name']} | ERROR: {r['error']} "
                         "| | | | | | | | | |")
            continue
        pps = r.get("pairs_per_sec") or r.get("pairs_per_sec_per_device")
        rms = r.get("rms_force_error")
        geo = (f"{r['leaf']} / {r['refine']} / {r['sections']}"
               if "leaf" in r else "-")
        lines.append(
            f"| {r['name']} | {r['ms_per_step']:.3f} | "
            f"{_cell(r.get('events_ms_per_step'), '.3f')} | "
            f"{r['steps_per_sec']:.2f} | {_cell(pps, '.3e')} | "
            f"{_cell(r.get('busy_share'), '.3f')} | "
            f"{'exact' if rms is None else format(rms, '.3e')} | "
            f"{_cell(r.get('overflow'), 'd')} | "
            f"{_cell(r.get('peak_gib'), '.2f')} | "
            f"{_cell(r.get('init_plus_first_s'), '.1f')} | {geo} |")
    return "\n".join(lines) + "\n"


def _row(name, fn, card):
    print(f"... {name}", file=sys.stderr, flush=True)
    try:
        rec = {"name": name, **fn()}
    except Exception as e:  # noqa: BLE001 - tabled, and main exits non-zero
        traceback.print_exc()
        rec = {"name": name, "error": f"{type(e).__name__}: {str(e)[:200]}"}
    measure.emit({"tool": "bench_suite", "card": card, **rec}, None)
    return rec


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the two small cases only")
    ap.add_argument("--xl", action="store_true",
                    help="add N = 16M and the sectioned N = 32M")
    ap.add_argument("--no-reuse", action="store_true",
                    help="skip the bh_rebuild_every = 8 make_run rows")
    ap.add_argument("--filter", default=None,
                    help="run only cases whose name contains this text")
    ap.add_argument("--out", default=None,
                    help=f"the markdown table (default {DEFAULT_OUT}, "
                         f"{FILTERED_OUT} with --filter)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the sharded row (default: one a card; "
                         "skipped below 2)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    card = measure.card_of(dev)
    out = args.out or (FILTERED_OUT if args.filter else DEFAULT_OUT)
    cases = (quick_cases() if args.quick or dev.type != "cuda"
             else full_cases(args.xl))

    def wanted(name):
        return not args.filter or args.filter in name

    rows = []
    for name, cfg in cases:
        if wanted(name):
            rows.append(_row(name, lambda: measure_step(cfg, dev), card))
    if not args.no_reuse:
        for name, cfg in cases:
            rname = f"{name} + rebuild interval {REUSE_K} (make_run)"
            if (cfg.resolve_force(dev) == "barnes_hut" and wanted(rname)):
                rows.append(_row(rname, lambda: measure_reuse(cfg, dev),
                                 card))
    n_ranks = args.ranks or (torch.cuda.device_count()
                             if dev.type == "cuda" else 0)
    if n_ranks > 1 and not args.filter:
        on_card = dev.type == "cuda"
        cfg = SimConfig(n=262144 if on_card else 4096,
                        force="direct_pallas" if on_card else "direct",
                        track_potential=False, **COMMON)
        rows.append(_row(f"sharded ring all-pairs n={cfg.n} x{n_ranks} "
                         "ranks", lambda: measure_sharded(cfg, n_ranks, dev),
                         card))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(table(rows, card))
    print(f"wrote {out}", file=sys.stderr)
    failed = [r["name"] for r in rows if "error" in r]
    if failed:
        raise SystemExit(f"bench_suite: {len(failed)} rows failed: "
                         + "; ".join(failed))
    return rows


if __name__ == "__main__":
    main()
