"""What every kernel wrapper shares (ops/bh_kernels.py, ops/direct_kernels.py):
the choice between the kernel and its plain version by device, the checks of
what a kernel takes, and the launch itself.

A wrapper runs its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises. There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch


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


def launch(counts: dict, name: str, fn: str, *args):
    """Call the C entry point `fn` of the kernel library with `args` and the
    current stream; raise on a nonzero CUDA error, else add one to
    counts[name]."""
    from parallelnbody_tpu_torch.kernels.build import load_library

    lib = load_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.pnb_error_string(err).decode()})")
    counts[name] += 1
