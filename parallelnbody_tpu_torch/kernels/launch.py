"""What every kernel wrapper shares (ops/bh_kernels.py, ops/direct_kernels.py):
the choice between the kernel and its plain version by device, the checks of
what a kernel takes, the launch itself, and the counters beside each
module's launch counts (`LAUNCHES`).

Counters (PERF.md names what reads each): a count the host already knows
(`COUNTERS`, host ints) counts always; a count that needs device work
(`DEVICE_COUNTERS`) counts only while tracing is on
(utils/profiling.tracing) and stays a device tensor until
`read_counters` reads it, so that no step waits on it. Every read of the
device by the host on the step path goes through `host_read`.

A wrapper runs its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises. There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from parallelnbody_tpu_torch.utils.profiling import span

COUNTERS = {
    "host_reads": 0,      # host_read calls: device-to-host reads
    "k3.pairs": 0,        # K3's target x source pairs
    "k3.sym_pairs": 0,    # K3's self-gravity pair evaluations (sym_pairs)
    "k1.pair_terms": 0,   # K1's list entries x G^2 (G the leaf size)
    "k1.sym_terms": 0,    # K1's mutual entries x G^2: unordered pair terms
                          # evaluated once for both leaves (near_pairs)
    "bh.heals": 0,        # list rebuilds after a calibrated budget clipped
                          # (ops/bh.py ListHeal)
    "bh.pot_evals": 0,    # Barnes-Hut force evaluations whose K1 and far
                          # field calls carried the potential (ops/bh.py,
                          # from ops/bh_kernels.POT_CALLS)
}
DEVICE_COUNTERS = {
    "far.terms": 0,       # K2's / K4's node x target terms (0-d tensor)
}


def on_cpu(*tensors) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors (the
    kernel); raises for tensors on several devices or another device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device type {dev.type!r}")
    return False


def check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def query(fn: str, *args) -> int:
    """The int that the C entry point `fn` (no kernel launch) returns for
    `args`; raise where it reports a CUDA error (a negative value)."""
    from parallelnbody_tpu_torch.kernels import build

    lib = build.load_library()
    value = getattr(lib, fn)(*args)
    if value < 0:
        raise RuntimeError(f"{fn} failed: CUDA error {-value} "
                           f"({lib.pnb_error_string(-value).decode()})")
    return value


def launch(counts: dict, name: str, fn: str, *args):
    """Call the C entry point `fn` of the kernel library with `args` and the
    current stream; raise on a nonzero CUDA error, else add one to
    counts[name]."""
    from parallelnbody_tpu_torch.kernels import build

    lib = build.load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.pnb_error_string(err).decode()})")
    counts[name] += 1


def count_on_device(name: str, value: torch.Tensor):
    """Add the 0-d device count `value` to DEVICE_COUNTERS[name], with no
    host wait; the caller counts only while tracing is on."""
    DEVICE_COUNTERS[name] = DEVICE_COUNTERS[name] + value


def read_counters() -> dict:
    """Every counter as a host int (one read of each device count)."""
    return {**COUNTERS, **{name: int(v)
                           for name, v in DEVICE_COUNTERS.items()}}


def host_read(t: torch.Tensor) -> list:
    """t.tolist(): a read of the device by the host on the step path, in a
    `host_read` span and counted in COUNTERS["host_reads"]."""
    with span("host_read"):
        COUNTERS["host_reads"] += 1
        return t.tolist()
