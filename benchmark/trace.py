"""Traced blocks of calls: torch.profiler over a whole number of `step(k)`
calls, reduced to what the per-layer metrics read.

The metrics' block records the device only (kernels, copies, fills and
the runtime calls that issue them), so that the profiler adds little to
the host's time; its window is the host clock's, from the first call's
start to the last call's synchronize. A reading is kept only where it is
whole (`yardstick.is_whole`); `record` tries up to `TRIES` blocks. A
second block records the host's ops as well, each call inside a span of
the benchmark's own, `bench.call`, and only names what the host was doing
in the device's idle gaps (`idle_gaps`): recording every host op slows the
host, so no metric reads that block.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import sys
from pathlib import Path

import torch

from benchmark import yardstick

TRIES = 3
SPAN = "bench.call"
TOP = 10


@dataclasses.dataclass
class Trace:
    """The reduced reading of one traced block, in seconds."""

    device: list          # [(name, start, end)]: kernels, copies, fills
    host: list            # [(name, start, end)]: host ops and runtime calls
    runtime_calls: dict   # {runtime call name: count}
    window: tuple         # (start, end) of the block on the same clock
    steps: int            # simulated steps in the block
    n: int                # particles
    hand_kernels: frozenset  # the program's hand-written kernel names
    step_s: float = None  # seconds a step of the untraced window

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        """Seconds of the window in which some device record ran."""
        w0, w1 = self.window
        return sum(max(0.0, min(e, w1) - max(s, w0))
                   for s, e in _union(self.device))

    def device_s(self, symbols=None, exclude=()):
        """Device seconds of the records whose name is one of `symbols`
        (every record where None), leaving out those named in `exclude`."""
        total = 0.0
        for name, s, e in self.device:
            if symbols is not None and not any(
                    yardstick.names_match(sym, name) for sym in symbols):
                continue
            if any(yardstick.names_match(sym, name) for sym in exclude):
                continue
            total += e - s
        return total


def _union(records):
    spans = sorted((s, e) for _, s, e in records)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def hand_kernels(package_dir):
    """The names of the program's hand-written CUDA kernels: every
    `__global__` function of its csrc/ sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    names = set()
    for path in sorted(Path(package_dir, "csrc").glob("*.cu*")):
        names.update(pat.findall(path.read_text()))
    return frozenset(names)


def _short(name):
    """A kernel's name without its return type, namespace wrapper and
    argument list: "void (anonymous namespace)::k<8>(float*)" -> "k<8>"."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()


def reduce(events, steps, n, kernels, window=None):
    """A Trace from torch.profiler's events (prof.events()); the window is
    the `bench.call` spans' unless given."""
    dev, host, runtime = [], [], collections.Counter()
    spans = []
    for e in events:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name == SPAN:
            # The span's host record; its device-side copy (the profiler's
            # annotation of the span on the stream) is no device work.
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((s, t))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
            if e.name in yardstick.DEVICE_CALLS:
                runtime[e.name] += 1
    if window is None:
        window = (min(s for s, _ in spans), max(t for _, t in spans))
    else:
        # The host clock's length, placed on the profiler's clock at the
        # first device record (the block starts with a launch).
        start = min((s for _, s, _ in dev), default=0.0)
        window = (start, start + window)
    return Trace(dev, host, dict(runtime), window, steps, n, kernels)


def is_whole(trace, launched):
    """The whole-reading rule on a Trace, against the kernel launches the
    program's counters saw during the block ({counter: launches})."""
    want = collections.Counter()
    for counter, count in launched.items():
        if counter in yardstick.KERNEL_SYMBOLS and count:
            want[yardstick.KERNEL_SYMBOLS[counter]] += count
    got = {sym: sum(1 for name, _, _ in trace.device
                    if yardstick.names_match(sym, name)) for sym in want}
    return yardstick.is_whole(len(trace.device), trace.busy_s,
                              trace.runtime_calls, dict(want), got)


def record(run_block, launches, steps, n, kernels):
    """Profile the device during run_block(), which makes calls of `steps`
    steps in all and returns (what it made, its window's host seconds), up
    to TRIES times: (the first whole Trace or None, what every block
    made). launches() reads the program's launch counters."""
    from torch.profiler import ProfilerActivity, profile

    made_all = []
    for attempt in range(TRIES):
        before = launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            made, wall = run_block()
        after = launches()
        made_all += made
        trace = reduce(prof.events(), steps, n, kernels, wall)
        launched = {k: after[k] - before.get(k, 0) for k in after}
        if is_whole(trace, launched):
            return trace, made_all
        print(f"trace: reading {attempt + 1} not whole "
              f"({len(trace.device)} device records, runtime calls "
              f"{trace.runtime_calls})", file=sys.stderr)
    return None, made_all


def record_host(run_block, steps, n, kernels):
    """Profile host and device during run_block(), whose calls run inside
    `bench.call` spans and which returns (what it made, its host seconds):
    (a Trace for `idle_gaps`, what run_block made)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        made, _ = run_block()
    return reduce(prof.events(), steps, n, kernels), made


def device_ops(trace):
    """The TOP device operations of the block by seconds."""
    ops = collections.Counter()
    for name, s, e in trace.device:
        ops[_short(name)] += e - s
    return [[k, v] for k, v in ops.most_common(TOP)]


def idle_gaps(trace):
    """The device's idle time in the window by what the host was doing:
    the innermost host op that covers the middle of each gap ("python"
    where none does), the TOP by seconds."""
    busy = [(s, e) for s, e in _union(trace.device)
            if e > trace.window[0] and s < trace.window[1]]
    gaps, t = [], trace.window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < trace.window[1]:
        gaps.append((t, trace.window[1]))
    # One sweep: host ops of one thread nest, so after pushing every op
    # that starts before a gap's middle and popping those that ended, the
    # top of the stack is the innermost op covering it.
    host = sorted(trace.host, key=lambda r: (r[1], -r[2]))
    idle = collections.Counter()
    stack, i = [], 0
    for mid, length in sorted((0.5 * (g0 + g1), g1 - g0) for g0, g1 in gaps):
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        idle[stack[-1][0] if stack else "python"] += length
    return [[k, v] for k, v in idle.most_common(TOP)]
