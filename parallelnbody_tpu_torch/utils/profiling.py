"""Profiling and timing helpers. Counterpart of
`parallelnbody_tpu/utils/profiling.py`.

`profile_trace(dir)` records a torch.profiler trace (CPU and, where there
is one, CUDA activity) of a region and writes it into `dir` as a Chrome
trace (`trace.json`), viewable in ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

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


class StepTimer:
    """Wall-clock steps/sec over a sliding window, with a true device sync."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps0 = 0

    def rate(self, state, steps_done: int) -> float | None:
        force_sync(state.time)
        now = time.perf_counter()
        if self._t0 is None:
            self._t0, self._steps0 = now, steps_done
            return None
        dt = now - self._t0
        ds = steps_done - self._steps0
        self._t0, self._steps0 = now, steps_done
        return ds / dt if dt > 0 else None
