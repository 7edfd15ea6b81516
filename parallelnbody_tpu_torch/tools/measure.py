"""What the card-measuring tools share: the H100's published rates, the
card's name and power limit, CUDA-event timing (one call, or rounds of
several calls in alternating order), the least time of a pair sum, the
parity checks against a reference output, and the JSON lines they print.
"""

from __future__ import annotations

import json
import subprocess

import torch

# The H100 SXM's published rates at 700 W.
FP32_FLOPS = 67e12          # FP32 outside the tensor cores
MUFU_RATE = FP32_FLOPS / 16  # rsqrt/s
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
HBM_BYTES = 3.35e12
ITERS = 10                  # timed calls after the warm-up


def card():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, iters=ITERS):
    """(the output of one warm-up call of fn(), mean device ms of iters
    calls after it), by CUDA events. A tool checks the warm-up's output,
    so that no launch is made only to compare."""
    first = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return first, start.elapsed_time(end) / iters


def events_ms(fn, iters=ITERS):
    """Mean device ms of iters calls of fn() after one warm-up call."""
    return timed(fn, iters)[1]


def rounds_ms(calls, rounds, iters):
    """({name: [ms of each round]}, {name: the output of its first warm-up
    call}) for calls {name: fn}: each round times every call (`timed`), in
    the given order on even rounds and in reverse on odd ones, so that a
    drift of the card's clock over the run falls on both ends of the list
    alike."""
    names = list(calls)
    out = {name: [0.0] * rounds for name in names}
    firsts = {}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            got, out[name][r] = timed(calls[name], iters)
            firsts.setdefault(name, got)
            del got
    return out, firsts


def spread(values):
    """min, median and max of a list of times."""
    v = sorted(values)
    return {"ms_min": v[0], "ms": v[len(v) // 2], "ms_max": v[-1]}


def pair_bound(pairs, flops_pair, n_bytes):
    """The least time for `pairs` pair terms of flops_pair FP32 operations
    and one rsqrt each, moving n_bytes, at the H100's published rates:
    bound_ms, bound_by ("operations" or "bytes") and the resource that
    sets it."""
    secs = {"fp32": pairs * flops_pair / FP32_FLOPS,
            "mufu": pairs / MUFU_RATE, "hbm": n_bytes / HBM_BYTES}
    res = max(secs, key=secs.get)
    return {"pairs": pairs, "bytes": n_bytes, "bound_ms": secs[res] * 1e3,
            "bound_by": "bytes" if res == "hbm" else "operations",
            "bound_resource": res}


def max_abs_err(name, got, want, rtol, atol):
    """max |got - want|; raises beyond atol + rtol |want| elementwise or on
    a non-finite value."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values beyond rtol "
                             f"{rtol} / atol {atol}; max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def rows_close(name, got, want, rtol, atol):
    """max |got - want| over (L, 4, G) outputs; raises beyond atol + rtol
    of each target row's largest |value| or on a non-finite value. For
    random sources, whose sums cancel to near zero in places: there two
    f32 orders of a row's terms differ by more than rtol of the element."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    if bool((err > atol + rtol * scale).any()):
        raise AssertionError(f"{name}: beyond rtol {rtol} of the row scale "
                             f"/ atol {atol}; max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def emit(rec, out):
    """Prints rec as one JSON line and appends it to the file out."""
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
