"""Profiling, timing and tracing helpers. Counterpart of
`parallelnbody_tpu/utils/profiling.py`.

`profile_trace(dir)` records a torch.profiler trace (CPU and, where there
is one, CUDA activity) of a region and writes it into `dir` as a Chrome
trace (`trace.json`), viewable in ui.perfetto.dev or chrome://tracing.

Tracing: `span(name)` marks one phase of the program at a layer boundary
(the step shell, the integrator, a force evaluation, a kernel wrapper, a
Barnes-Hut phase; PERF.md names each span and what reads it). While
tracing is off, the default, it returns one shared context that does
nothing: one test of a module-level bool, no allocation, no torch call.
`tracing(True)` switches it on. Each span then keeps a record in memory
(`Span`: name, id, the enclosing span's id, the id of its call, start and
end on `time.perf_counter_ns()`); a span opened while none is open starts
a call, and every span inside it shares that call's id. While a torch
profiler runs, a span is also a `torch.profiler.record_function` range, so
the profiler's trace shows the phase on the device records' clock, with the
kernels and copies it launched tied to it. `take_spans()` hands over the
records kept so far and forgets them; `self_times` reduces them.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from pathlib import Path
from typing import NamedTuple

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Wrap a region in a torch.profiler trace written to
    <log_dir>/trace.json if log_dir is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))


def _first_tensor(tree) -> torch.Tensor | None:
    """The first tensor leaf of a tensor, a NamedTuple (such as SimState), a
    tuple, a list or a dict (by sorted key), depth first: the order in which
    jax.tree.leaves lists a pytree's leaves. None where there is none."""
    if isinstance(tree, torch.Tensor):
        return tree
    items = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else \
        tree if isinstance(tree, (tuple, list)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def force_sync(tree) -> float:
    """Wait for the work behind `tree` (a tensor, or a NamedTuple, tuple,
    list or dict holding tensors) and return its first tensor leaf's first
    element as a host float: a device synchronize where that tensor lies on
    a CUDA device, then one host read. Counterpart of the JAX package's
    force_sync, which takes any pytree."""
    t = _first_tensor(tree)
    if t is None:
        raise ValueError(f"force_sync: no tensor in {type(tree).__name__}")
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


# ------------------------------------------------------------------ tracing
class Span(NamedTuple):
    """One finished span; times in host nanoseconds."""

    name: str
    id: int
    parent: int     # id of the enclosing span, -1 for the first of a call
    call: int       # id of its call: the outermost span's id
    start_ns: int
    end_ns: int


_tracing = False
_spans: list[Span] = []
_open: list = []        # the open spans, innermost last
_ids = itertools.count()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "call", "start", "mirror")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = -1 if outer is None else outer.id
        self.call = self.id if outer is None else outer.call
        self.mirror = None
        if torch.autograd._profiler_enabled():
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        _open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        _spans.append(Span(self.name, self.id, self.parent, self.call,
                           self.start, end))
        return False


def span(name: str):
    """A context marking the phase `name`: nothing while tracing is off, a
    kept record (and, under a running profiler, a record_function range)
    while it is on."""
    if not _tracing:
        return _NO_SPAN
    return _OpenSpan(name)


class tracing:
    """Switch tracing on (True) or off. Used as a context, the setting it
    found comes back on exit: `with tracing(True): ...`."""

    def __init__(self, on: bool = True):
        global _tracing
        self._was = _tracing
        _tracing = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _tracing
        _tracing = self._was
        return False


def is_tracing() -> bool:
    return _tracing


def take_spans() -> list[Span]:
    """The spans finished since the last call, in the order they ended;
    they are forgotten here."""
    out = list(_spans)
    _spans.clear()
    return out


def self_times(spans) -> dict:
    """{name: seconds} of each span name's self time: a span's duration
    less its child spans' (spans nest on the one host thread). A child
    whose parent is not in `spans` counts for no one."""
    total: dict = {}
    by_id = {s.id: s for s in spans}
    for s in spans:
        length = (s.end_ns - s.start_ns) * 1e-9
        total[s.name] = total.get(s.name, 0.0) + length
        parent = by_id.get(s.parent)
        if parent is not None:
            total[parent.name] = total.get(parent.name, 0.0) - length
    return total
