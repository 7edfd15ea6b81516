"""The port's C++ oracle (native/: its own copy of oracle.cpp, built by g++
at first use into build/native/, bound by ctypes) against the JAX
package's: the same source and flags, so every result is equal bit for
bit; the binding refuses arrays of the wrong shape."""

import shutil

import numpy as np
import pytest

from parallelnbody_tpu.native import Oracle as JaxOracle
from parallelnbody_tpu_torch.native import Oracle, build_oracle_lib
from parallelnbody_tpu_torch.native import oracle as native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)), rng.standard_normal((n, 3)) * 0.1,
            rng.uniform(0.5, 2.0, n))


def test_source_is_the_jax_package_copy():
    from parallelnbody_tpu.native import oracle as jnative

    assert native.SRC.read_bytes() == jnative._SRC.read_bytes()
    assert build_oracle_lib() is build_oracle_lib()
    assert native.library_path().is_file()
    assert native.library_path().parent.name == "native"


@pytest.mark.parametrize("softening", [0.0, 0.02])
def test_accel_and_energy_equal_jax(softening):
    pos, vel, mass = _rand(96)
    t, j = Oracle(1.5, softening), JaxOracle(1.5, softening)
    for a, b in zip(t.accel(pos, mass), j.accel(pos, mass)):
        np.testing.assert_array_equal(a, b)
    assert t.total_energy(pos, vel, mass) == j.total_energy(pos, vel, mass)


@pytest.mark.parametrize("integrator", ["leapfrog", "euler_semi_implicit"])
def test_run_equal_jax(integrator):
    pos, vel, mass = _rand(64, seed=1)
    t = Oracle(1.0, 0.05).run(pos, vel, mass, 1e-3, 20, integrator)
    j = JaxOracle(1.0, 0.05).run(pos, vel, mass, 1e-3, 20, integrator)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_wrong_shape_raises():
    pos, vel, mass = _rand(8)
    with pytest.raises(ValueError, match="shape"):
        Oracle().accel(pos[:7], mass)
    with pytest.raises(ValueError, match="shape"):
        Oracle().total_energy(pos, vel[:, :2], mass)
