"""The port's IC families against the JAX package's.

The port draws from a CPU torch.Generator and the JAX package from
jax.random, so for one seed the two give different samples of the same
distributions. Each family is held to the JAX one statistically at
N = 20000: the masses are the same arrays (bar reference_slab's random
masses), the centre of mass and mean velocity are zero where the JAX
family centres them, and the radius and the speed have the same distribution:
their empirical CDFs differ by at most KS_BOUND = 0.025 at every value (the
two-sample Kolmogorov-Smirnov statistic; for two samples of 20000 from one
distribution it exceeds 0.025 with probability 2 exp(-12.5) ~ 7.5e-6).
two_body draws nothing: its arrays equal the JAX package's. The semantics
of tests/test_models.py (the slab's bounds, the circular binary, the two
clumps, the rotating disk, virialization) are checked on the port's own ICs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from parallelnbody_tpu import config as jconfig
from parallelnbody_tpu.models import IC_REGISTRY as J_REGISTRY
from parallelnbody_tpu.models import get_ic as j_get_ic
from parallelnbody_tpu_torch import config as tconfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.models import IC_REGISTRY, get_ic
from parallelnbody_tpu_torch.ops.direct import direct_accel
from parallelnbody_tpu_torch.ops.energy import (kinetic_energy,
                                                potential_energy)

torch.set_num_threads(2)

N = 20000
KS_BOUND = 0.025
ALL_ICS = sorted(J_REGISTRY)
# Families whose positions / velocities the JAX package centres.
CENTRED_POS = {"plummer", "hernquist", "king", "nfw"}
CENTRED_VEL = CENTRED_POS | {"uniform_sphere"}


def _both(name, n=N, seed=0, **cfg_kw):
    jcfg = jconfig.SimConfig(n=n, ic=name, **cfg_kw)
    tcfg = tconfig.SimConfig(n=n, ic=name, **cfg_kw)
    j = [np.asarray(a, np.float64)
         for a in j_get_ic(name)(jax.random.key(seed), jcfg)]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    t = [a.double().numpy() for a in get_ic(name)(gen, tcfg)]
    return j, t


def _ks(a, b):
    """Two-sample Kolmogorov-Smirnov statistic: the largest difference
    between the empirical CDFs of samples a and b."""
    a, b = np.sort(a), np.sort(b)
    x = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, x, side="right") / len(a)
                               - np.searchsorted(b, x, side="right")
                               / len(b))))


def test_registry_holds_every_family_of_the_jax_package():
    assert sorted(IC_REGISTRY) == ALL_ICS == sorted(tconfig.IC_KINDS)


def test_unknown_ic_raises_value_error():
    with pytest.raises(ValueError, match="unknown IC"):
        get_ic("no_such_scene")


@pytest.mark.parametrize("name", ALL_ICS)
def test_ic_statistics_match_jax(name):
    (jp, jv, jm), (tp, tv, tm) = _both(name)
    for a in (tp, tv, tm):
        assert a.shape[0] == N and np.all(np.isfinite(a))
    if name == "reference_slab":
        assert tm[0] == jm[0] == 5000.0
        np.testing.assert_allclose(tm[1:].mean(), jm[1:].mean(), rtol=0.02)
    else:
        np.testing.assert_array_equal(tm.astype(np.float32),
                                      jm.astype(np.float32))
    if name in CENTRED_POS:
        assert np.abs(tp.mean(0)).max() < 1e-6
    if name in CENTRED_VEL:
        assert np.abs(tv.mean(0)).max() < 1e-6
    if name == "two_body":
        return  # equal arrays: test_two_body_equals_jax
    if name == "galaxy_collision":
        # Each galaxy about its own centre.
        halves = [slice(0, N // 2), slice(N // 2, N)]
        pairs = [(jp[h] - jp[h].mean(0), tp[h] - tp[h].mean(0))
                 for h in halves]
    elif name == "disk":
        pairs = [(np.hypot(jp[:, 0], jp[:, 1]), np.hypot(tp[:, 0], tp[:, 1])),
                 (np.abs(jp[:, 2]), np.abs(tp[:, 2]))]
    elif name in ("reference_slab", "uniform_cube"):
        pairs = [(np.abs(jp[:, c]), np.abs(tp[:, c])) for c in range(3)]
    else:
        pairs = [(jp, tp)]
    for j, t in pairs:
        jr = j if j.ndim == 1 else np.linalg.norm(j, axis=1)
        tr = t if t.ndim == 1 else np.linalg.norm(t, axis=1)
        assert _ks(tr, jr) < KS_BOUND, "radius"
    if name in ("cold_sphere", "uniform_cube"):
        assert not tv.any() and not jv.any()
    else:
        assert _ks(np.linalg.norm(tv, axis=1),
                   np.linalg.norm(jv, axis=1)) < KS_BOUND, "speed"


@pytest.mark.parametrize("name", ALL_ICS)
def test_ic_deterministic_under_seed(name):
    cfg = tconfig.SimConfig(n=128, ic=name)
    runs = [get_ic(name)(torch.Generator().manual_seed(7), cfg)
            for _ in range(2)]
    other = get_ic(name)(torch.Generator().manual_seed(8), cfg)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    if name != "two_body":
        assert not torch.equal(runs[0][0], other[0])


@pytest.mark.parametrize("name", ALL_ICS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ic_dtype_and_shapes(name, dtype):
    cfg = tconfig.SimConfig(n=256, ic=name, dtype=dtype)
    pos, vel, mass = get_ic(name)(torch.Generator().manual_seed(0), cfg)
    assert pos.shape == vel.shape == (256, 3) and mass.shape == (256,)
    assert pos.dtype == vel.dtype == mass.dtype == getattr(torch, dtype)
    assert bool((mass >= 0).all())


@pytest.mark.parametrize("n", [2, 16])
def test_two_body_equals_jax(n):
    """two_body draws nothing: the same arrays as the JAX package, and the
    circular speed sqrt(G m / (4 a)) (tests/test_models.py:64)."""
    (jp, jv, jm), (tp, tv, tm) = _both("two_body", n=n)
    for t, j in ((tp, jp), (tv, jv), (tm, jm)):
        np.testing.assert_array_equal(t.astype(np.float32),
                                      j.astype(np.float32))
    np.testing.assert_allclose(np.linalg.norm(tv[0]), np.sqrt(0.5 / 4.0),
                               rtol=1e-6)


def test_reference_slab_semantics():
    """Slab bounds, speed range, mass range, central body (OctreeSearch.cpp
    :58-72; tests/test_models.py:48)."""
    cfg = tconfig.SimConfig(n=4096, ic="reference_slab", ic_size=200.0)
    pos, vel, mass = (a.numpy() for a in get_ic("reference_slab")(
        torch.Generator().manual_seed(0), cfg))
    assert np.all(np.abs(pos[:, :2]) <= 200.0)
    assert np.all(np.abs(pos[:, 2]) <= 20.0)
    speeds = np.linalg.norm(vel[1:], axis=1)
    assert speeds.min() >= 250.0 - 1e-3 and speeds.max() <= 500.0 + 1e-3
    assert mass[1:].min() >= 1.0 and mass[1:].max() <= 5000.0
    assert not pos[0].any() and not vel[0].any() and mass[0] == 5000.0


def test_galaxy_collision_two_clumps():
    cfg = tconfig.SimConfig(n=2048, ic="galaxy_collision", ic_size=1.0)
    pos, vel, mass = (a.numpy() for a in get_ic("galaxy_collision")(
        torch.Generator().manual_seed(0), cfg))
    assert np.mean(pos[:1024, 0]) < -2.0 and np.mean(pos[1024:, 0]) > 2.0
    assert np.mean(vel[:1024, 0]) > 0 and np.mean(vel[1024:, 0]) < 0
    np.testing.assert_allclose(mass.sum(), 2.0, rtol=1e-5)


def test_disk_rotates_and_takes_placement():
    cfg = tconfig.SimConfig(n=4096, ic="disk", ic_size=1.0)
    disk = get_ic("disk")
    pos, vel, mass = disk(torch.Generator().manual_seed(0), cfg)
    lz = float(torch.sum(mass * (pos[:, 0] * vel[:, 1]
                                 - pos[:, 1] * vel[:, 0])))
    assert lz > 0.1  # net angular momentum about z
    p2, v2, _ = disk(torch.Generator().manual_seed(0), cfg,
                     center=(1.0, 2.0, 3.0), velocity=(0.5, 0.0, 0.0),
                     spin=-1)
    torch.testing.assert_close(p2, pos + torch.tensor([1.0, 2.0, 3.0]))
    torch.testing.assert_close(v2, -vel + torch.tensor([0.5, 0.0, 0.0]))


def test_virialize_option():
    """virialize=True rescales speeds so 2K + W = 0 at t=0
    (tests/test_models.py:89)."""
    cfg = tconfig.SimConfig(n=2048, ic="nfw", softening=0.02, force="direct",
                            dtype="float64", virialize=True)
    state = init_simulation(cfg, "cpu")
    ke = float(kinetic_energy(state.vel, state.mass))
    w = float(potential_energy(state.pot, state.mass))
    assert abs(2 * ke + w) / abs(w) < 1e-6


def test_virialize_with_untracked_potential():
    """virialize=True uses the real potential when the run's
    track_potential=False (tests/test_models.py:102)."""
    cfg = tconfig.SimConfig(n=2048, ic="plummer", softening=0.02,
                            force="barnes_hut", theta=0.6, virialize=True,
                            track_potential=False)
    state = init_simulation(cfg, "cpu")
    ke = float(kinetic_energy(state.vel, state.mass))
    assert ke > 1e-6
    _, pot = direct_accel(state.pos, state.mass, g=cfg.g,
                          softening=cfg.softening)
    w = float(potential_energy(pot, state.mass))
    assert abs(2 * ke + w) / abs(w) < 1e-2


def test_reference_compat_config_equals_jax():
    j = dataclasses.asdict(jconfig.reference_compat_config())
    t = dataclasses.asdict(tconfig.reference_compat_config())
    assert t == j
    j = dataclasses.asdict(jconfig.reference_compat_config(n=77, size=3.0))
    t = dataclasses.asdict(tconfig.reference_compat_config(n=77, size=3.0))
    assert t == j
    cfg = tconfig.reference_compat_config()
    assert cfg.softening == 0.0 and cfg.resolve_force("cuda") == "direct"
