"""Build and load the hand-written CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles every source under parallelnbody_tpu_torch/csrc/ for Hopper
(sm_90a) into one shared library with a plain C interface under
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (name, argtypes, restype).
_SIGNATURES = (
    ("pnb_near_field",
     [_VP] * 7 + [_I, _I, _I, _F, _F, _I, _I, _VP], _I),
    ("pnb_far_octet",
     [_VP] * 6 + [_I, _I, _I, _I, _F, _F, _I, _I, _VP], _I),
    ("pnb_allpairs",
     [_VP] * 4 + [_I, _I, _F, _I, _I, _VP], _I),
    ("pnb_far_gather",
     [_VP] * 7 + [_I, _I, _I, _I, _F, _F, _I, _I, _I, _VP], _I),
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


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Returns its path; nvcc's output (register and shared-memory use) is kept
    beside it with the suffix .log."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
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
