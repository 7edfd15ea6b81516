"""ctypes binding and first-use build of the C++ direct-sum oracle.

Counterpart of `parallelnbody_tpu/native/oracle.py`, with the same `Oracle`
API. `oracle.cpp` is the port's own copy of the JAX package's source. At
first use `g++` compiles it into build/native/ at the root of the checkout,
under a name that carries a hash of the source and flags (an edit forces a
rebuild); a failed build raises with the compiler's output. Nothing is
built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("oracle.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liboracle_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_oracle_lib() -> ctypes.CDLL:
    """Compile (once) and load the oracle shared library, with every entry
    point's argtypes and restype declared."""
    lib_path = library_path()
    if not lib_path.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH; the C++ oracle is "
                               "built from source at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed with exit code "
                                   f"{proc.returncode}:\n{proc.stderr}")
            os.replace(tmp, lib_path)  # a concurrent loader sees all or nothing
        finally:
            tmp.unlink(missing_ok=True)

    lib = ctypes.CDLL(str(lib_path))
    d = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    lib.nbody_direct_accel.argtypes = [d, d, i64, f64, f64, d, d]
    lib.nbody_direct_accel.restype = None
    lib.nbody_leapfrog_steps.argtypes = [d, d, d, i64, f64, f64, f64, i64, d, d]
    lib.nbody_leapfrog_steps.restype = None
    lib.nbody_semi_euler_steps.argtypes = [d, d, d, i64, f64, f64, f64, i64, d, d]
    lib.nbody_semi_euler_steps.restype = None
    lib.nbody_total_energy.argtypes = [d, d, d, i64, f64, f64]
    lib.nbody_total_energy.restype = f64
    return lib


def _f64(a, shape) -> np.ndarray:
    """a as a C-contiguous float64 array of `shape`; raises otherwise, so
    that no pointer reaches the library over a wrong-sized buffer."""
    a = np.ascontiguousarray(a, np.float64)
    if a.shape != shape:
        raise ValueError(f"expected shape {shape}, got {a.shape}")
    return a


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class Oracle:
    """Double-precision CPU direct-sum oracle (reference force law)."""

    def __init__(self, g: float = 1.0, softening: float = 0.0):
        self.g = float(g)
        self.eps = float(softening)
        self._lib = build_oracle_lib()

    def accel(self, pos, mass):
        mass = np.ascontiguousarray(mass, np.float64)
        n = mass.shape[0]
        pos = _f64(pos, (n, 3))
        acc = np.zeros((n, 3), np.float64)
        pot = np.zeros(n, np.float64)
        self._lib.nbody_direct_accel(_as_c(pos), _as_c(mass), n,
                                     self.g, self.eps, _as_c(acc), _as_c(pot))
        return acc, pot

    def run(self, pos, vel, mass, dt: float, steps: int,
            integrator: str = "leapfrog"):
        """Integrate `steps` steps; returns (pos, vel) copies."""
        mass = np.ascontiguousarray(mass, np.float64)
        n = mass.shape[0]
        pos = _f64(pos, (n, 3)).copy()
        vel = _f64(vel, (n, 3)).copy()
        acc, pot = self.accel(pos, mass)
        fn = {
            "leapfrog": self._lib.nbody_leapfrog_steps,
            "euler_semi_implicit": self._lib.nbody_semi_euler_steps,
        }[integrator]
        fn(_as_c(pos), _as_c(vel), _as_c(mass), n, self.g, self.eps,
           float(dt), int(steps), _as_c(acc), _as_c(pot))
        return pos, vel

    def total_energy(self, pos, vel, mass) -> float:
        mass = np.ascontiguousarray(mass, np.float64)
        n = mass.shape[0]
        pos = _f64(pos, (n, 3))
        vel = _f64(vel, (n, 3))
        return float(self._lib.nbody_total_energy(
            _as_c(pos), _as_c(vel), _as_c(mass), n, self.g, self.eps))
