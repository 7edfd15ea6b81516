"""The comparison that decides `correct`.

A judged call is one `step(k)` call of the timed path: the state it was
handed (every particle's position and velocity, and the acceleration the
program carried in) and the state it returned. The reference follows the
call from that input state in float64 (`reference.nbody.leapfrog_at`) at
sampled targets, drawn from the seed, and three numbers compare the
program's answer with it, each the relative rms over the targets,
sqrt(mean |got - want|^2) / sqrt(mean |want|^2), and each the largest over
the judged calls:

  acc_err  the accelerations: the one carried into the call against the
           direct sum at the input positions, and the one returned against
           the direct sum at the reference's positions after the k steps
           (the force evaluation: tree, lists, K1 and K2, or K3);
  dx_err   the displacement over the call, pos_out - pos_in (the drift of
           the leapfrog update, and the particle order that the exit
           unsort restores);
  dv_err   the velocity change over the call, vel_out - vel_in (the kicks).

Two counts are held to 0: `failed_calls` (calls that raised, left a
non-finite state or grew the list-overflow counter) and `steps_off` (the
step counter of the final state against the steps the calls asked for).

The limits of a cell are in its workload file (`limits`), set from the
readings of sound runs and of the control (PERF.md).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from benchmark.reference.nbody import leapfrog_at

NUMBERS = ("acc_err", "dx_err", "dv_err", "failed_calls", "steps_off")


@dataclasses.dataclass
class Judged:
    """One judged call, on the host, in float64: the input state of every
    particle, and the program's rows at the targets."""

    steps: int
    mass: torch.Tensor      # (N,)
    pos_in: torch.Tensor    # (N, 3)
    vel_in: torch.Tensor    # (N, 3)
    acc_in: torch.Tensor    # (k, 3) at the targets
    pos_out: torch.Tensor   # (k, 3)
    vel_out: torch.Tensor   # (k, 3)
    acc_out: torch.Tensor   # (k, 3)


def take(steps, state_in, state_out, targets):
    """A Judged from the program's input and output states of one call."""
    def f64(t):
        return t.detach().to("cpu", torch.float64)

    t = targets.to(state_in.pos.device)
    return Judged(steps, f64(state_in.mass), f64(state_in.pos),
                  f64(state_in.vel),
                  f64(state_in.acc[t]), f64(state_out.pos[t]),
                  f64(state_out.vel[t]), f64(state_out.acc[t]))


def rel_rms(got, want):
    num = torch.sqrt(torch.mean(torch.sum((got - want) ** 2, -1)))
    den = torch.sqrt(torch.mean(torch.sum(want ** 2, -1)))
    return float(num / den)


# The precisions the reference computes in: float64 for the comparison;
# bfloat16, the nearest below the configurations' float32 (no matrix unit
# is on the path, so TF32 does not arise), for the control; float32 to show
# where a plain float32 sum lands.
CONTROLS = {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}


def follow(judged, targets, phys, device, precision="float64"):
    """The reference's answer to a judged call, computed on `device` in
    `precision` (a key of CONTROLS): (a0, x, v, a) at the targets, as
    float64 on the host."""
    dtype = CONTROLS[precision]
    out = leapfrog_at(judged.pos_in.to(device, dtype),
                      judged.vel_in.to(device, dtype),
                      judged.mass.to(device, dtype), targets.to(device),
                      steps=judged.steps, **phys)
    return tuple(t.to("cpu", torch.float64) for t in out)


def numbers(judged, want, targets):
    """{acc_err, dx_err, dv_err} of one judged call against the
    reference's (a0, x, v, a) at the targets, `want`."""
    a0, x, v, a = want
    x0 = judged.pos_in[targets]
    v0 = judged.vel_in[targets]
    return {
        "acc_err": max(rel_rms(judged.acc_in, a0),
                       rel_rms(judged.acc_out, a)),
        "dx_err": rel_rms(judged.pos_out - x0, x - x0),
        "dv_err": rel_rms(judged.vel_out - v0, v - v0),
    }


def stand_in(judged, got):
    """The judged call with the program's answer replaced by `got` = (a0,
    x, v, a), the control's answer to the same input state."""
    a0, x, v, a = got
    return dataclasses.replace(judged, acc_in=a0, pos_out=x, vel_out=v,
                               acc_out=a)


def verdict(values, limits):
    """(correct, checks): every number at or under its limit (a missing or
    non-finite number fails), and {name: {"value", "limit"}} in the order
    of NUMBERS. Prints one line a number on standard error."""
    checks = {}
    ok = True
    for name in NUMBERS:
        value, limit = values.get(name), limits[name]
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if good else 'FAILED'}", file=sys.stderr)
    return ok, checks
