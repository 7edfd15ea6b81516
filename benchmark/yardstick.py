"""The benchmark's fixed arithmetic: the H100's published peaks, the least
time of a pair sum, the rule that tells a whole profiler reading from one
that lost records, and the percentile the harness reports.

Copied from the program's `tools/measure.py` (peaks, `pair_bound`,
`DEVICE_CALLS`, `KERNEL_SYMBOLS`, the rule of `busy_reading`) so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math
import re

# The H100 SXM's published rates at 700 W (NVIDIA's data sheet, dense).
FP32_FLOPS = 67e12           # FP32 outside the tensor cores
MUFU_RATE = FP32_FLOPS / 16  # rsqrt/s
HBM_BYTES = 3.35e12          # bytes/s
# FP32 operations of a softened monopole pair term without the potential
# (an FMA as two); one rsqrt beside them.
FLOPS_MONOPOLE = 18

# The runtime calls of which each puts one kernel, copy or fill on the
# device.
DEVICE_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaMemcpyAsync", "cudaMemsetAsync"})
# The device kernel each counted launch of the program's wrappers runs once
# (the keys are the program's launch counters; a wrapper's second kernel,
# such as K1's combine, has its own name).
KERNEL_SYMBOLS = {"near_field": "near_field_kernel",
                  "near_field_window": "near_field_kernel",
                  "near_field_table": "near_field_kernel",
                  "far_octet": "far_octet_kernel",
                  "far_gather": "far_gather_kernel",
                  "allpairs": "allpairs_kernel"}


def least_seconds(pairs, flops_pair, n_bytes):
    """The least time (s) of `pairs` pair terms of flops_pair FP32
    operations and one rsqrt each, moving n_bytes, at the published rates,
    and the resource that sets it ("fp32", "mufu" or "hbm")."""
    secs = {"fp32": pairs * flops_pair / FP32_FLOPS,
            "mufu": pairs / MUFU_RATE, "hbm": n_bytes / HBM_BYTES}
    res = max(secs, key=secs.get)
    return secs[res], res


def names_match(symbol, name):
    """True where the device record `name` is the kernel `symbol`."""
    return re.search(rf"\b{re.escape(symbol)}\b", name) is not None


def is_whole(n_records, busy_s, runtime_calls, launched, recorded):
    """The whole-reading rule: some device time, no fewer device records
    than runtime calls that put one on the device, and one record of each
    kernel launch that the program's counters saw ({symbol: launches}
    against {symbol: records}). A session that lost records, or took some
    of an earlier session's, is not whole."""
    calls = sum(n for name, n in runtime_calls.items()
                if name in DEVICE_CALLS)
    return busy_s > 0 and n_records >= calls and recorded == launched


def p95(values):
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
