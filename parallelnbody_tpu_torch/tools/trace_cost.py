"""What the program's tracing costs and what its spans read, on one CUDA
device.

    python3 -m parallelnbody_tpu_torch.tools.trace_cost --config FILE
        [--k 1] [--calls 64] [--rounds 3] [--modes off,on,profile]
        [--device cuda] [--out FILE]

The configuration file's run (`api.prepare_simulation`, its ICs from its
seed) is driven as `Simulation.step(k)` drives it: `make_step` for k = 1,
`make_run(cfg, k)` otherwise, each call ended by a synchronize, one call
after another. Each round runs one block of --calls calls in each mode, in
the order given:

  off      tracing off (utils/profiling.py), as every run but a traced one;
  on       tracing on, no profiler: the spans' host self times
           (`profiling.self_times`) a step, among them the host shell's
           (`api.step`, `api.run`, `api.block`) and the integrator's;
  profile  tracing on under torch.profiler (CPU and CUDA): the device's
           idle time inside the `api.step` / `api.run` spans over the
           block's window (its first such span's start to the later of its
           last span's end and the last device record's), `step_idle_share`.

Each block reports ms a step (its wall from the first call's start to the
last call's synchronize, over its steps). In a checkout whose port has no
tracing (an older one, this file copied into its tools/) only "off" runs.
`--device cpu` (the tests) runs the plain versions; its times are the
CPU's and no device's. Every line is one JSON object carrying the
card's name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse
import time

import torch

from parallelnbody_tpu_torch import SimConfig, api
from parallelnbody_tpu_torch.tools import measure

SHELL = ("api.step", "api.run", "api.block")
CALL_SPANS = ("api.step", "api.run")


def step_call(cfg, k):
    return (api.make_step(cfg, report_overflow=True) if k == 1
            else api.make_run(cfg, k, report_overflow=True))


def block(call, state, calls, device):
    """(state after `calls` calls, the block's wall seconds)."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    t0 = time.perf_counter()
    for _ in range(calls):
        state, _ = call(state)
        sync()
    return state, time.perf_counter() - t0


def _union(ranges):
    """The (start, end) ranges merged where they overlap, in order."""
    out = []
    for s, t in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def idle_in_spans(events, span_names):
    """(idle seconds inside the call spans, window seconds) of a profiled
    block's events (prof.events()): the device records, less the device
    copies of the spans themselves, against the union of the host's
    `api.step` / `api.run` ranges (an `api.step` inside an `api.run`
    counts once)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            if e.name not in span_names:
                dev.append((s, t))
        elif e.name in CALL_SPANS:
            spans.append((s, t))
    busy, spans = _union(dev), _union(spans)
    idle = 0.0
    for s, t in spans:
        idle += (t - s) - sum(max(0.0, min(t, b1) - max(s, b0))
                              for b0, b1 in busy)
    end = max([t for _, t in spans] + [t for _, t in busy])
    return idle, end - min(s for s, _ in spans)


def run_mode(mode, call, state, calls, steps, device):
    """(state, the mode's record)."""
    if mode == "off":
        state, wall = block(call, state, calls, device)
        return state, {"ms_per_step": 1e3 * wall / steps}
    from parallelnbody_tpu_torch.utils import profiling

    profiling.take_spans()
    if mode == "on":
        with profiling.tracing(True):
            state, wall = block(call, state, calls, device)
        self_s = profiling.self_times(profiling.take_spans())
        per_step = {name: 1e3 * s / steps for name, s in self_s.items()}
        return state, {
            "ms_per_step": 1e3 * wall / steps,
            "shell_host_ms_per_step": sum(per_step.get(n, 0.0)
                                          for n in SHELL),
            "integrator_host_ms_per_step": per_step.get("integrator", 0.0),
            "self_ms_per_step": per_step}
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, profiling.tracing(True):
        state, wall = block(call, state, calls, device)
    names = {s.name for s in profiling.take_spans()}
    rec = {"ms_per_step": 1e3 * wall / steps}
    if device.type == "cuda":
        idle, window = idle_in_spans(prof.events(), names)
        rec.update(step_idle_share=idle / window, window_s=window)
    return state, rec


def probe(cfg, device, k, calls, rounds, modes, out):
    cfg, state = api.prepare_simulation(cfg, device)
    call = step_call(cfg, k)
    state, _ = block(call, state, 3, device)     # warm-up
    steps = calls * k
    card = measure.card_of(device)
    for r in range(rounds):
        for mode in modes:
            state, rec = run_mode(mode, call, state, calls, steps, device)
            measure.emit({"n": cfg.n, "force": cfg.force, "k": k,
                          "calls": calls, "round": r, "mode": mode, **rec,
                          "card": card}, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--k", type=int, default=1, help="steps a call")
    ap.add_argument("--calls", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--modes", default="off,on,profile")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = measure.device_of(args.device)
    with open(args.config) as f:
        cfg = SimConfig.from_json(f.read())
    probe(cfg, device, args.k, args.calls, args.rounds,
          args.modes.split(","), args.out)


if __name__ == "__main__":
    main()
