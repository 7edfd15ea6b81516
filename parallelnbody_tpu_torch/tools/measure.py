"""What the card-measuring tools share: the H100's published rates, the
card's name and power limit, CUDA-event timing (one call, or rounds of
several calls in alternating order), the device's busy time from
torch.profiler (a reading held against the launches it saw) and a
phase's two times, the least time of a pair sum, the parity checks
against a reference output (among them the pyramid refresh's,
`pyramid_close`), and the JSON lines they print.
"""

from __future__ import annotations

import json
import re
import subprocess

import torch

from parallelnbody_tpu_torch.ops import bh, bh_kernels, direct_kernels

# The H100 SXM's published rates at 700 W.
FP32_FLOPS = 67e12          # FP32 outside the tensor cores
MUFU_RATE = FP32_FLOPS / 16  # rsqrt/s
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
HBM_BYTES = 3.35e12
ITERS = 10                  # timed calls after the warm-up
# A profiler session on the card now and then loses some or all of its
# device records (tools/bh_breakdown.py, NVIDIA H100 80GB HBM3, 700.00 W:
# a traverse with none, then a list build at 0.49 of its 2.1 ms).
# `busy_reading` tells a whole reading from such a one; `busy_ms` tries
# this many, and counts them in READINGS.
BUSY_TRIES = 3
READINGS = {"whole": 0, "not_whole": 0}
# The device kernel each counted launch of the port's wrappers runs once
# (a wrapper's second kernel, such as K1's combine, has its own name).
KERNEL_SYMBOLS = {"near_field": "near_field_kernel",
                  "near_field_window": "near_field_kernel",
                  "near_field_table": "near_field_kernel",
                  "far_octet": "far_octet_kernel",
                  "far_gather": "far_gather_kernel",
                  "allpairs": "allpairs_kernel"}
# The runtime calls of which each puts one kernel, copy or fill on the
# device.
DEVICE_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaMemcpyAsync", "cudaMemsetAsync"})
# FP32 operations of a softened monopole pair term without the potential
# and of the quadrupole term of K2 and K4 (csrc/terms.cuh quad_term), an
# FMA as two; one rsqrt each beside them.
FLOPS_MONOPOLE = 18
FLOPS_QUADRUPOLE = 48


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


def _launches():
    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}


def busy_reading(fn):
    """(busy ms, whole) of one call of fn() under torch.profiler: the
    device time of its kernels, copies and fills, and whether the reading
    is whole: some device time, no fewer device records than the runtime
    calls that put one on the device, and one record of each port kernel
    launch the wrappers counted. A session that lost records, or took
    some of an earlier session's, is not whole."""
    from torch.profiler import ProfilerActivity, profile

    before = _launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    after = _launches()
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    launched = {}
    for name, sym in KERNEL_SYMBOLS.items():
        launched[sym] = launched.get(sym, 0) + after[name] - before[name]
    recorded = {sym: sum(e.count for e in dev
                         if re.search(rf"\b{sym}\b", e.key))
                for sym in launched}
    busy = sum(getattr(e, "self_device_time_total", 0) for e in dev) / 1e3
    calls = sum(e.count for e in events if e.key in DEVICE_CALLS)
    return busy, (busy > 0 and sum(e.count for e in dev) >= calls
                  and recorded == launched)


def busy_ms(fn):
    """The device time (ms) of the kernels, copies and fills that one call
    of fn() runs, from the first whole `busy_reading` of up to BUSY_TRIES
    calls; None where none was whole. Beside the call's time on the
    events clock it gives the device's busy share."""
    for _ in range(BUSY_TRIES):
        busy, whole = busy_reading(fn)
        READINGS["whole" if whole else "not_whole"] += 1
        if whole:
            return busy
    return None


def phase(fn, iters, device):
    """(the output of a first call of fn(), {"ms", "busy_ms",
    "busy_share"}) of one phase. On a CUDA device: ms is the mean of iters
    calls after the first by CUDA events, the wall time on the stream, the
    host's waits inside the phase included; busy_ms is `busy_ms` of
    one more call (None where no reading was whole); busy_share =
    busy_ms / ms. On the CPU (the tests' plain versions) one call and
    None for each: no device was timed."""
    if torch.device(device).type != "cuda":
        return fn(), {"ms": None, "busy_ms": None, "busy_share": None}
    out, ms = timed(fn, iters)
    busy = busy_ms(fn)
    return out, {"ms": ms, "busy_ms": busy,
                 "busy_share": None if busy is None else busy / ms}


def card_of(device):
    """`card()` on a CUDA device; "cpu" elsewhere."""
    return card() if torch.device(device).type == "cuda" else "cpu"


def device_of(name):
    """torch.device(name); raises SystemExit for a CUDA device where torch
    has none: a tool asked for the card does not fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: torch.cuda.is_available() is False; "
                         "the tools measure the card (--device cpu runs "
                         "the plain versions, for the tests)")
    return dev


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


# The pyramid refresh's pass against its plain version (pyramid_close):
# the mass and the centre within f32 rounding of sums over up to G bodies
# (or a node's children) taken in another order, the centre also within
# 1e-6 of the domain's half-extent, which is how closely an f32 centre at
# that distance is known; the quadrupole within QUAD_TOL of the node's sum
# m |d|^2 (with that centre floor): each of its terms m (3 dx dx - |d|^2)
# rounds relative to m |d|^2, not to the often cancelling sum, so two
# summation orders differ on that scale.
PYRAMID_RTOL = 1e-5
QUAD_TOL = 1e-5


def _node_scale(pos_s, mass_s, tree, leaf, n8):
    """(n8,) float64: each row's sum m |d|^2 about its centre (the plain
    tree's), a leaf's over its bodies, an upper node's its children's plus
    their masses at their centres (the parallel axis), the levels stacked
    8-aligned as bh._nodes_all_octet stacks them (pad rows 0)."""
    com = [c.double() for c in tree.com]
    n_leaves = com[0].shape[0]
    d = pos_s.double().reshape(n_leaves, leaf, 3) - com[0][:, None]
    s = [torch.sum(mass_s.double().reshape(n_leaves, leaf) *
                   torch.sum(d * d, -1), 1)]
    del d
    for k in range(1, len(com)):
        b = com[k - 1].shape[0] // com[k].shape[0]
        dc = com[k - 1].reshape(-1, b, 3) - com[k][:, None]
        mk = tree.mass[k - 1].double().reshape(-1, b)
        s.append(s[-1].reshape(-1, b).sum(1) +
                 torch.sum(mk * torch.sum(dc * dc, -1), 1))
    out = torch.zeros(n8, dtype=torch.float64, device=pos_s.device)
    widths, rows, _ = bh._pyramid_plan(n_leaves, len(s))
    for w, r, sk in zip(widths, rows, s):
        out[r:r + w] = sk
    return out


def pyramid_close(name, got, want, pos_s, mass_s, *, leaf_size, max_levels,
                  n_live):
    """The pass's packed node table `got` against the plain one `want`
    (bh.refresh_plain) on the sorted rows pos_s /
    mass_s: rows of mass 0 (empty nodes and pads) the same bits, the
    others within PYRAMID_RTOL and QUAD_TOL; raises otherwise. Returns the
    largest relative mass error, centre error over its tolerance and
    quadrupole error over its scale."""
    empty = want[:, 3] == 0
    if not torch.equal(got[empty], want[empty]):
        raise AssertionError(f"{name}: rows of mass 0 differ")
    _, half, _ = bh._cube_of(pos_s[:n_live])
    floor = 1e-6 * float(half)
    g, w = got[~empty].double(), want[~empty].double()
    errs = {"mass": float(((g[:, 3] - w[:, 3]).abs() / w[:, 3]).max()),
            "com": float(((g[:, :3] - w[:, :3]).abs() / (
                PYRAMID_RTOL * w[:, :3].abs() + floor)).max()),
            "quad": 0.0}
    if got.shape[1] == 12:
        tree = bh._live_tree(pos_s, mass_s, n_live, leaf_size=leaf_size,
                             multipole=2, max_levels=max_levels)
        scale = _node_scale(pos_s, mass_s, tree, leaf_size,
                            got.shape[0])[~empty] + w[:, 3] * floor ** 2
        errs["quad"] = float(((g[:, 4:10] - w[:, 4:10]).abs().amax(1) /
                              scale).max())
    if errs["mass"] > PYRAMID_RTOL or errs["com"] > 1 or \
            errs["quad"] > QUAD_TOL:
        raise AssertionError(f"{name}: mass {errs['mass']:.3e}, centre "
                             f"{errs['com']:.3f} of its tolerance, "
                             f"quadrupole {errs['quad']:.3e} of its scale")
    return errs


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
