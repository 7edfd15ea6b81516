"""The JAX package's small public helpers and their counterparts in the
port: ops/direct.py direct_energy, ops/morton.py morton_decode, state.py
domain_half_extent and center_of_mass. The same seeded numpy inputs go
through both, in f64 to 1e-12 (the keys' cells exactly equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu import state as jstate
from parallelnbody_tpu.ops.direct import direct_energy as j_direct_energy
from parallelnbody_tpu.ops.morton import morton_decode as j_morton_decode
from parallelnbody_tpu.ops.morton import morton_encode as j_morton_encode
from parallelnbody_tpu_torch import state as tstate
from parallelnbody_tpu_torch.ops.direct import direct_energy
from parallelnbody_tpu_torch.ops.morton import morton_decode, morton_encode

torch.set_num_threads(2)

TOL = 1e-12


def _particles(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * np.array([1.0, 0.5, 2.0])
    vel = rng.normal(size=(n, 3)) * 0.3
    mass = rng.uniform(0.5, 1.5, size=n) / n
    return pos, vel, mass


def _states(n, seed):
    pos, vel, mass = _particles(n, seed)
    js = jstate.make_state(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(mass), None, dtype=jnp.float64)
    ts = tstate.make_state(pos, vel, mass, device="cpu", dtype=torch.float64)
    return js, ts


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("n,seed", [(256, 0), (333, 1)])
def test_direct_energy_matches_jax(n, seed, softening):
    pos, vel, mass = _particles(n, seed)
    want = j_direct_energy(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(mass), g=1.5, softening=softening)
    got = direct_energy(torch.from_numpy(pos), torch.from_numpy(vel),
                        torch.from_numpy(mass), g=1.5, softening=softening)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(float(g), float(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bits", [10, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_morton_decode_matches_jax(seed, bits):
    """Decoded cells of random keys equal the JAX package's exactly, and
    decoding the keys of quantized positions gives back their cells."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << (3 * bits), size=4096, dtype=np.int32)
    got = morton_decode(torch.from_numpy(keys), bits)
    want = np.asarray(j_morton_decode(jnp.asarray(keys), bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    pos = rng.uniform(-1.0, 1.0, size=(4096, 3)).astype(np.float32)
    center, half = np.zeros(3, np.float32), np.float32(1.0)
    k_t = morton_encode(torch.from_numpy(pos), torch.from_numpy(center),
                        torch.tensor(half), bits)
    k_j = np.asarray(j_morton_encode(jnp.asarray(pos), jnp.asarray(center),
                                     jnp.asarray(half), bits))
    np.testing.assert_array_equal(k_t.numpy(), k_j)
    np.testing.assert_array_equal(morton_decode(k_t, bits).numpy(),
                                  np.asarray(j_morton_decode(k_j, bits)))


@pytest.mark.parametrize("n,seed", [(1000, 0), (4097, 3)])
def test_domain_half_extent_and_center_of_mass_match_jax(n, seed):
    js, ts = _states(n, seed)
    for fn in ("domain_half_extent", "center_of_mass"):
        got = getattr(tstate, fn)(ts)
        want = np.asarray(getattr(jstate, fn)(js))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
