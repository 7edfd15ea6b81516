"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles every source under parallelnbody_tpu_torch/csrc/ for Hopper
(sm_90a), one process per source, all started together, and links the
objects into one shared library with a plain C interface under
build/kernels/ at the root of the checkout. The file name carries a hash of
the sources and flags, so an edit forces a rebuild and a stale library is
never loaded. The library is loaded with ctypes; every pointer and the
stream are passed as c_void_p. A failed build raises with nvcc's output.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (name, argtypes, restype).
_SIGNATURES = (
    ("pnb_near_field",
     [_VP] * 8 + [_I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _VP], _I),
    ("pnb_near_field_pairs",
     [_VP] * 9 + [_I, _I, _I, _I, _F, _F, _I, _I, _VP], _I),
    ("pnb_near_pairs_count", [_VP] * 8 + [_I, _I, _I, _VP], _I),
    ("pnb_near_pairs_emit", [_VP] * 10 + [_I, _I, _I, _I, _VP], _I),
    ("pnb_far_octet",
     [_VP] * 7 + [_I, _I, _I, _I, _F, _F, _I, _I, _VP], _I),
    ("pnb_allpairs",
     [_VP] * 4 + [_I, _I, _I, _F, _I, _I, _VP], _I),
    ("pnb_allpairs_splits", [_I, _I], _I),
    ("pnb_allpairs_self", [_VP] * 4 + [_I, _I, _F, _I, _I, _VP], _I),
    ("pnb_allpairs_mma",
     [_VP] * 4 + [_I, _I, _F, _I, _I, _I, _I, _I, _VP], _I),
    ("pnb_allpairs_mma_splits", [_I, _I, _I], _I),
    ("pnb_mma_tf32_probe", [_VP] * 4 + [_I, _I, _VP], _I),
    ("pnb_far_gather",
     [_VP] * 8 + [_I, _I, _I, _I, _F, _F, _I, _I, _I, _VP], _I),
    ("pnb_near_probe", [_VP] * 7 + [_I] * 10 + [_F, _VP], _I),
    ("pnb_near_flat", [_VP] * 6 + [_I] * 5 + [_F, _I, _I, _VP], _I),
    ("pnb_near_flat_lanes", [_VP] * 6 + [_I] * 6 + [_F, _VP], _I),
    ("pnb_pyramid_leaves", [_VP] * 5 + [_I] * 6 + [_VP], _I),
    ("pnb_pyramid_top", [_VP] * 4 + [_I] * 4 + [_VP], _I),
    ("pnb_pyramid_fill", [_VP] * 3 + [_I] * 4 + [_VP], _I),
    ("pnb_error_string", [_I], ctypes.c_char_p),
)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> Path:
    return BUILD_DIR / f"libpnb_kernels_{source_hash()}.so"


def _run_all(cmds) -> list[tuple[list[str], subprocess.CompletedProcess]]:
    """Run the commands at once; wait for all of them."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    out = []
    for cmd, p in procs:
        stdout, _ = p.communicate()
        out.append((cmd, subprocess.CompletedProcess(cmd, p.returncode,
                                                     stdout)))
    return out


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Returns its path; nvcc's output (register and shared-memory use) is kept
    beside it with the suffix .log."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        steps = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                          str(src)] for src, obj in zip(sources(), objs))
        if all(p.returncode == 0 for _, p in steps):
            steps += _run_all([[nvcc, "-shared", "-o", str(tmp),
                                *map(str, objs)]])
        log = "".join(f"$ {' '.join(cmd)}\n{p.stdout}" for cmd, p in steps)
        failed = [p.returncode for _, p in steps if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n"
                               f"{log}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C entry
    point's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes, restype in _SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
