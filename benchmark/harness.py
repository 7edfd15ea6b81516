"""One run of one cell: set-up, warm-up, the measured window, the traced
block (`--trace 1`), the comparison with the reference, one JSON line.

The entry the window drives is `Simulation.step(k)`'s own: the initial
conditions made here from the seed (`inputs/<ic>.py`), then
`api.prepare_simulation(cfg, device, state=...)` (budget calibration at
t = 0 and one step on, the t = 0 forces), then the call that
`Simulation.step(k)` makes: `api.make_step(cfg, report_overflow=True)` for
k = 1, `api.make_run(cfg, k, report_overflow=True)` otherwise.

The traffic is a closed loop with one caller: each call is one step(k) of
`steps_per_call` steps ended by a synchronize; the caller then reads the
call's overflow counter and whether its state is finite, and makes the
next call. The window runs until `--seconds` have passed at the end of a
call.

Judged calls (check.py): the first warm-up call (its input is the
prepared state: the start), the first call of the window, one call of the
window drawn from the seed, the last, and the last call from the seed's
own sphere (below). The reference runs once the window has closed, the
peak memory has been read and the program's state is freed.

The window's inputs are one fixed sphere in the order the seed draws
(`inputs/<ic>.py`), so every seed gives the program the same work.
`force_rms_err` is read on the window's first call at the same particles
of that sphere in every run. After the window the program is also driven,
through the same entry, from the sphere that the seed itself draws: its
calls count in `failed_calls` and its last call is judged like the
window's, so that a fault that shows on some spheres only can fail a run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import check, manifest, trace as tracing, yardstick
from benchmark.reference import nbody as reference

# Top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole; the port's name begins with the JAX package's).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "parallelnbody_tpu"})
FORCE_SAMPLE = 4096     # targets of force_rms_err


def parse(argv):
    p = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="Run one cell of BENCHMARK.json once; print one JSON "
                    "line.")
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a traced "
                        "block of calls")
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def sim_config(cell, seed, overrides=None):
    from parallelnbody_tpu_torch.config import SimConfig

    fields = {f.name for f in dataclasses.fields(SimConfig)}
    kw = {k: v for k, v in cell.config.items() if k in fields}
    kw.update(overrides or {})
    kw["seed"] = seed
    return SimConfig(**kw)


def inputs(cfg, seed, drawn=False):
    """(pos, vel, mass, order) of the window (row j is the fixed sphere's
    particle order[j]), or with drawn=True (pos, vel, mass, None) of the
    sphere that the seed draws."""
    module = importlib.import_module(f"benchmark.inputs.{cfg.ic}")
    if drawn:
        return (*module.sphere(cfg.n, seed, cfg.ic_size), None)
    return module.initial_conditions(cfg.n, seed, cfg.ic_size)


def prepare(cell, seed, device, overrides=None, drawn=False):
    """(cfg, state, order, marks): the cell's configuration with the seed,
    its inputs (`inputs`) on `device`, both through
    `api.prepare_simulation`; marks times the inputs and the preparation."""
    from parallelnbody_tpu_torch import api
    from parallelnbody_tpu_torch.state import make_state

    cfg = sim_config(cell, seed, overrides)
    marks = {"imports": time.perf_counter()}
    pos, vel, mass, order = inputs(cfg, seed, drawn)
    state = make_state(pos, vel, mass, seed=seed, device=device,
                       dtype=cfg.dtype)
    marks["inputs"] = time.perf_counter()
    cfg, state = api.prepare_simulation(cfg, device, state=state)
    marks["prepare"] = time.perf_counter()
    return cfg, state, order, marks


def step_call(cfg, k):
    """The call that `Simulation.step(k)` makes, reporting the overflow
    counter."""
    from parallelnbody_tpu_torch import api

    return (api.make_step(cfg, report_overflow=True) if k == 1
            else api.make_run(cfg, k, report_overflow=True))


def drawn_run(cell, seed, device, targets, overrides=None):
    """(judged last call, failed calls): the same entry driven from the
    sphere that the seed draws, prepared and through the traffic's
    `drawn_calls` calls."""
    k = cell.traffic["steps_per_call"]
    cfg, state, _, _ = prepare(cell, seed, device, overrides, drawn=True)
    caller = Caller(step_call(cfg, k), device)
    for _ in range(cell.traffic["drawn_calls"]):
        state_in = state
        state, _, _ = caller(state)
    return check.take(k, state_in, state, targets), caller.failed


def card():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def launch_counts():
    from parallelnbody_tpu_torch.ops import bh_kernels, direct_kernels

    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}


class Caller:
    """The one caller of the closed loop: makes calls, times each from its
    start to its synchronize, and counts the ones that failed. A call
    followed by its check is `__call__`; the traced blocks make calls
    alone and check them after the profiler has stopped, so that no metric
    reads the check's own launches."""

    def __init__(self, call, device):
        self.call, self.device = call, device
        self.failed = 0
        self.calls = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, state):
        """(state after the call, its overflow counter or None where it
        raised, its start, its end)."""
        self.calls += 1
        t0 = time.perf_counter()
        try:
            out, overflow = self.call(state)
            self.sync()
        except Exception:  # a call that raises is a failed call
            traceback.print_exc(file=sys.stderr)
            self._fail("raised")
            return state, None, t0, time.perf_counter()
        return out, overflow, t0, time.perf_counter()

    def check(self, out, overflow):
        """Count the call failed where its overflow counter grew or its
        state is not finite (a NaN or inf anywhere makes the sums so): one
        read of the device."""
        if overflow is None:
            return
        grew, total = torch.stack([
            overflow.to(torch.float64).reshape(()),
            out.pos.sum(dtype=torch.float64) + out.vel.sum(dtype=torch.float64)
            + out.acc.sum(dtype=torch.float64)]).tolist()
        if grew > 0 or not math.isfinite(total):
            self._fail(f"overflow {grew:g}, state sum {total}")

    def __call__(self, state):
        """(state after the call, its start, its end), the call checked."""
        out, overflow, t0, t1 = self.timed(state)
        self.check(out, overflow)
        return out, t0, t1

    def _fail(self, why):
        if not self.failed:
            print(f"call {self.calls - 1} failed first: {why}",
                  file=sys.stderr)
        self.failed += 1


def run_cell(cell, seed, seconds, trace=False, device="cuda", t0=None,
             overrides=None, controls=()):
    """Run `cell` once and return its result (the JSON line's object).
    device="cpu" runs the program's plain versions, for the tests; the
    command line never does. `controls` (keys of check.CONTROLS, for
    control.py and the tests): the reference in each of these precisions
    is also put in the program's place on every judged call, and its
    numbers returned under "control"."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    traffic = cell.traffic
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError(f"{cell.traffic_name}: only a closed loop with "
                         "one caller is implemented")
    k = traffic["steps_per_call"]
    cfg, state, order, marks = prepare(cell, seed, device, overrides)
    call = step_call(cfg, k)
    caller = Caller(call, device)
    rng = np.random.default_rng([seed, 1])
    targets = torch.as_tensor(np.sort(rng.choice(
        cfg.n, min(cell.targets, cfg.n), replace=False)))
    held = {}

    # Warm-up: this cell's shapes only, a fixed number of calls.
    for i in range(traffic["warmup_calls"]):
        out, _, _ = caller(state)
        if i == 0:
            held["start"] = (state, out)
        state = out
    marks["warm-up"] = time.perf_counter()

    traced = host_traced = None
    if trace and device.type == "cuda":    # a CPU run records no device
        import parallelnbody_tpu_torch
        kernels = tracing.hand_kernels(parallelnbody_tpu_torch.__path__[0])
        calls, steps = traffic["trace_calls"], traffic["trace_calls"] * k

        def block(span=False):
            """Calls alone, each in a `bench.call` span where asked: (what
            they made, the host seconds from the first start to the last
            end)."""
            nonlocal state
            made = []
            for _ in range(calls):
                with (torch.profiler.record_function(tracing.SPAN) if span
                      else contextlib.nullcontext()):
                    state, overflow, a, b = caller.timed(state)
                made.append((state, overflow, a, b))
            return made, made[-1][3] - made[0][2]

        traced, made = tracing.record(block, launch_counts, steps, cfg.n,
                                      kernels)
        host_traced, more = tracing.record_host(lambda: block(True), steps,
                                                cfg.n, kernels)
        for out, overflow, _, _ in made + more:
            caller.check(out, overflow)
        del made, more

    # The window.
    caller_failed_before = caller.failed
    times = []
    t_start = time.perf_counter()
    setup_s = t_start - t0
    while True:
        out, a, b = caller(state)
        times.append((a, b))
        i = len(times) - 1
        if i == 0:
            held["first"] = (state, out)
        elif rng.random() * i < 1.0:   # one call of 1..i, each as likely
            held["picked"] = (state, out)
        held["last"] = (state, out)
        state = out
        if b - t_start >= seconds:
            break
    window_failed = caller.failed - caller_failed_before
    wall = times[-1][1] - times[0][0]

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    steps_done = int(state.step)
    steps_asked = caller.calls * k
    judged = [check.take(k, s_in, s_out, targets)
              for s_in, s_out in held.values()]
    want_rms = not trace and any(m["name"] == "force_rms_err"
                                 for m in cell.end_to_end)
    mass64 = state.mass.detach().to("cpu", torch.float64)
    if want_rms:      # the same particles of the fixed sphere in every run
        rows = torch.as_tensor(np.argsort(order))[
            reference.strided(cfg.n, FORCE_SAMPLE)]
        first_out = held["first"][1]
        rms_in = (first_out.pos.detach().to("cpu", torch.float64),
                  first_out.acc.detach().to("cpu", torch.float64))
        del first_out
    del state, out, held, call, caller.call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The program from the seed's own sphere, then the reference, in
    # float64.
    t_ref = time.perf_counter()
    last, drawn_failed = drawn_run(cell, seed, device, targets, overrides)
    judged.append(last)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phys = dict(dt=cfg.dt, g=cfg.g, softening=cfg.softening)
    values = {"acc_err": 0.0, "dx_err": 0.0, "dv_err": 0.0}
    control = {p: dict(values) for p in controls}
    for j in judged:
        want = check.follow(j, targets, phys, device)
        got = check.numbers(j, want, targets)
        values = {name: max(values[name], got[name]) for name in values}
        for p in controls:
            stand_in = check.stand_in(j, check.follow(j, targets, phys,
                                                      device, p))
            got = check.numbers(stand_in, want, targets)
            control[p] = {name: max(control[p][name], got[name])
                          for name in got}
    values["failed_calls"] = caller.failed + drawn_failed
    values["steps_off"] = abs(steps_done - steps_asked)
    e2e = {
        "step_ms": 1e3 * wall / (len(times) * k),
        "call_p95_ms": 1e3 * yardstick.p95([b - a for a, b in times]),
        "setup_s": setup_s,
    }
    if want_rms:
        e2e["force_rms_err"] = reference.rms_force_error_sample(
            rms_in[0].to(device), mass64.to(device), rms_in[1].to(device),
            g=cfg.g, softening=cfg.softening, idx=rows)
    t_ref = time.perf_counter() - t_ref
    if trace:
        metrics = {}
        if traced is not None:
            traced.step_s = wall / (len(times) * k)
        for entry in cell.per_layer:
            value = (manifest.load_metric(entry["name"]).read(traced)
                     if traced is not None else None)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["card"] = card()
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
    durations = sorted(b - a for a, b in times)
    last = t0
    phases = []
    for name, at in marks.items():
        phases.append(f"{name} {at - last:.3f}")
        last = at
    print(f"{cell.name} seed {seed}: {len(times)} calls of {k} steps in "
          f"{wall:.3f} s (call ms min {1e3 * durations[0]:.3f} median "
          f"{1e3 * durations[len(durations) // 2]:.3f} max "
          f"{1e3 * durations[-1]:.3f}; first {1e3 * (times[0][1] - times[0][0]):.3f}); "
          f"set-up {setup_s:.3f} s ({', '.join(phases)}); "
          f"reference {t_ref:.3f} s; "
          f"{dev.get('card', '')}", file=sys.stderr)
    correct, checks = check.verdict(values, cell.limits)
    result = {"correct": correct, "attempted": len(times),
              "failed": window_failed, "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = {"device_ops": tracing.device_ops(traced),
                               "idle_gaps": tracing.idle_gaps(host_traced)}
    if controls:
        result["control"] = control
    result["checks"] = checks
    return result


def main(argv, t0=None):
    args = parse(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"modules that a run may not load: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
