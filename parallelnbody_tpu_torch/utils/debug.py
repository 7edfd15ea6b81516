"""Numerical-health checks. Counterpart of `parallelnbody_tpu/utils/debug.py`.

The failure modes left to a run are numerical (NaN/Inf from unsoftened
close encounters, f32 overflow) and structural (mismatched shapes):

  * validate_state(): shape/dtype/finiteness audit of a SimState.
  * check_finite(): one reduction on the tensors' device, one host read;
    raises FloatingPointError naming the tag.
  * debug_nans(): a context manager that checks each state handed to it
    (a run loop hands it every segment's state). JAX's `jax_debug_nans`, which
    re-runs the op that made the first NaN, has no torch counterpart: the
    check names the segment, not the op.
"""

from __future__ import annotations

import contextlib

import torch

from parallelnbody_tpu_torch.state import SimState

_STATE_FIELDS = ("pos", "vel", "acc", "mass", "pot")


class StateValidationError(ValueError):
    pass


def validate_state(state: SimState, check_values: bool = True) -> None:
    """Host-side audit: shapes, dtypes, finiteness, positive masses."""
    n = state.pos.shape[0]
    expect = {"pos": (n, 3), "vel": (n, 3), "acc": (n, 3),
              "mass": (n,), "pot": (n,)}
    for name, shape in expect.items():
        arr = getattr(state, name)
        if tuple(arr.shape) != shape:
            raise StateValidationError(
                f"{name}: shape {tuple(arr.shape)} != {shape}")
        if arr.dtype != state.pos.dtype:
            raise StateValidationError(
                f"{name}: dtype {arr.dtype} != {state.pos.dtype}")
    if check_values:
        for name in expect:
            bad = int(torch.sum(~torch.isfinite(getattr(state, name))))
            if bad:
                raise StateValidationError(f"{name}: {bad} non-finite values")
        if bool(torch.any(state.mass < 0)):
            raise StateValidationError("mass: negative values")


def check_finite(tag: str, *tensors) -> None:
    """Raise FloatingPointError if any of `tensors` holds a NaN or Inf: one
    reduction on their device and one host read."""
    flags = torch.stack([torch.all(torch.isfinite(t)) for t in tensors])
    if not bool(torch.all(flags)):
        raise FloatingPointError(f"non-finite values detected at {tag!r}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Yield check(tag, state): check_finite over the state's pos, vel,
    acc and pot when enable is True, a no-op otherwise. A run hands it each
    segment's state, so the first non-finite value is caught at the
    segment that produced it:

        with debug_nans() as check:
            for k in segments:
                state = run_k(state, k)
                check(f"step {int(state.step)}", state)
    """
    def check(tag: str, state: SimState) -> None:
        if enable:
            check_finite(tag, state.pos, state.vel, state.acc, state.pot)

    yield check
