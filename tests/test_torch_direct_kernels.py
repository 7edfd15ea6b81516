"""K3 (all-pairs) in the port against the JAX package: the plain version
behind `allpairs_accel_tile` on the CPU against `pallas_accel_tile` (the
Pallas kernel in interpret mode, as tests/test_pallas.py runs it), the
force="direct_pallas" path through Simulation in both packages from the same
ICs, and the C++-oracle drift gate of tests/test_oracle.py through the port.

Tolerances:
  * kernel tests: rtol 2e-4, atol 2e-4, the bounds of tests/test_pallas.py
    (the same f32 terms summed in another order, another rsqrt);
  * Simulation: rtol 1e-4 on positions and velocities, and on accelerations
    with an absolute floor of 1e-6 x the largest |acc| (the bounds of
    tests/test_torch_slice.py);
  * oracle: energy drift < 1e-4 over 1000 steps, trajectory within 0.05 of
    the float64 oracle's (the gates of tests/test_oracle.py).

On the CPU the wrapper runs the plain version and launches nothing; the
kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu import api as japi
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.ops.pallas_direct import pallas_accel_tile
from parallelnbody_tpu_torch import Simulation, SimConfig
from parallelnbody_tpu_torch import api as tapi
from parallelnbody_tpu_torch.ops import direct_kernels
from parallelnbody_tpu_torch.ops.direct import direct_accel
from parallelnbody_tpu_torch.state import state_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-4


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _both(pos_i, pos_j, mass_j, **kw):
    """(port, JAX) (acc, pot) of targets pos_i against (pos_j, mass_j)."""
    t = direct_kernels.allpairs_accel_tile(
        torch.from_numpy(pos_i), torch.from_numpy(pos_j),
        torch.from_numpy(mass_j), **kw)
    j = pallas_accel_tile(jnp.asarray(pos_i), jnp.asarray(pos_j),
                          jnp.asarray(mass_j), interpret=True, **kw)
    return t, j


def _close(t, j, rtol=RTOL, atol=ATOL):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("softening", [0.0, 0.05])
@pytest.mark.parametrize("n", [64, 300, 512])
def test_allpairs_matches_pallas(n, softening):
    pos, mass = _rand(n)
    t, j = _both(pos, pos, mass, g=1.5, softening=softening)
    assert np.all(np.isfinite(t[0].numpy()))
    _close(t, j)


def test_rectangular_targets_and_sources():
    """Targets != sources (the ring-pass shape), also through the ring's
    tile function."""
    pos_i, _ = _rand(96, seed=1)
    pos_j, mass_j = _rand(160, seed=2)
    t, j = _both(pos_i, pos_j, mass_j, g=1.0, softening=0.02)
    _close(t, j)
    tile_fn = direct_kernels.make_allpairs_tile_fn(
        SimConfig(g=1.0, softening=0.02))
    _close(tile_fn(*(torch.from_numpy(a) for a in (pos_i, pos_j, mass_j))),
           j)


def test_padding_contributes_nothing():
    """N = 130 is no multiple of any tile: the Pallas kernel pads with zero
    mass, the port's plain version streams row blocks; both agree with the
    direct sum."""
    pos, mass = _rand(130, seed=3)
    t, j = _both(pos, pos, mass, g=1.0, softening=0.01)
    _close(t, j)
    ref = direct_accel(torch.from_numpy(pos), torch.from_numpy(mass), g=1.0,
                       softening=0.01)
    _close(t, ref)


def test_coincident_particles_no_nan():
    pos = np.zeros((16, 3), np.float32)
    mass = np.ones(16, np.float32)
    (acc, pot), _ = _both(pos, pos, mass, g=1.0, softening=0.0)
    assert np.all(np.isfinite(acc.numpy()))
    np.testing.assert_allclose(acc.numpy(), 0.0)
    np.testing.assert_allclose(pot.numpy(), 0.0)


def test_potential_skipped_and_nothing_launched():
    """compute_pot=False leaves the potential at zero; on the CPU the
    wrapper runs the plain version and launches no kernel."""
    pos, mass = _rand(200, seed=4)
    direct_kernels.reset_launch_counts()
    (acc, pot), (ja, _) = _both(pos, pos, mass, g=1.0, softening=0.02,
                                compute_pot=False)
    _close((acc,), (ja,))
    assert not bool(torch.any(pot != 0))
    assert direct_kernels.LAUNCHES == {"allpairs": 0}


def test_plain_streams_row_blocks(monkeypatch):
    """The row-block streaming of the plain version (one block at these
    sizes on the CPU by default) gives the same sums block by block."""
    pos, mass = _rand(300, seed=5)
    args = [torch.from_numpy(a) for a in (pos, pos, mass)]
    whole = direct_kernels.allpairs_plain(*args, softening=0.02)
    monkeypatch.setattr(direct_kernels, "_PLAIN_BLOCK_ELEMS", 300 * 7)
    blocked = direct_kernels.allpairs_plain(*args, softening=0.02)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("softening", [0.0, 0.02])
@pytest.mark.parametrize("n", [1, 2, 130, 300])
def test_allpairs_self_on_cpu_is_the_plain_version(n, softening, compute_pot):
    """allpairs_self on CPU tensors runs allpairs_plain(pos, pos, mass):
    the same bits, whatever N; it launches nothing."""
    pos, mass = (torch.from_numpy(a) for a in _rand(n, seed=n))
    mass[::3] = 0.0
    direct_kernels.reset_launch_counts()
    kw = dict(softening=softening, compute_pot=compute_pot)
    got = direct_kernels.allpairs_self(pos, mass, **kw)
    assert torch.equal(got, direct_kernels.allpairs_plain(pos, pos, mass,
                                                          **kw))
    assert direct_kernels.LAUNCHES == {"allpairs": 0}


def test_allpairs_accel_routes_through_allpairs_self(monkeypatch):
    """make_allpairs_accel (the force of force="direct_pallas") evaluates
    through allpairs_self, once an evaluation, and scales as
    allpairs_accel_tile does; the ring's tile function keeps allpairs."""
    pos, mass = (torch.from_numpy(a) for a in _rand(96, seed=6))
    cfg = SimConfig(g=1.5, softening=0.02)
    calls = []
    real = direct_kernels.allpairs_self

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(direct_kernels, "allpairs_self", spy)
    acc, pot = direct_kernels.make_allpairs_accel(cfg, mass)(pos)
    assert calls == [dict(softening=0.02, compute_pot=True)]
    want = direct_kernels.allpairs_accel_tile(pos, pos, mass, g=1.5,
                                              softening=0.02)
    assert torch.equal(acc, want[0]) and torch.equal(pot, want[1])
    direct_kernels.make_allpairs_tile_fn(cfg)(pos, pos, mass)
    assert len(calls) == 1


@pytest.mark.parametrize("n,tiles", [(1, 1), (2048, 1), (2049, 2),
                                     (6149, 4), (262144, 128)])
def test_self_gravity_plan_counts(n, tiles):
    """The self-gravity form's tiles and pair evaluations: each of the
    nb (nb + 1) / 2 tile pairs (the diagonal included) of SYM_TILE^2."""
    assert direct_kernels.sym_tiles(n) == tiles
    assert direct_kernels.sym_pairs(n) == (direct_kernels.SYM_TILE ** 2
                                           * tiles * (tiles + 1) // 2)
    assert direct_kernels.N_SYM <= 262144 <= direct_kernels.N_SYM_MAX


@pytest.mark.parametrize("n,chunks", [(2048, 1), (4096, 2), (65536, 4),
                                      (131072, 2), (196608, 4), (262144, 5)])
def test_self_gravity_chunks(n, chunks):
    """sym_chunks on the H100's 132 SMs: the chunk counts its sweep ran
    (4 at 196608, where 2 and 3 left SMs with twice the tile pairs), each
    leaving every block at least one item."""
    assert direct_kernels.sym_chunks(n, 132) == chunks
    items = direct_kernels.sym_tiles(n) // 2 + 1
    assert 1 <= chunks <= min(items, direct_kernels.MAX_CHUNKS)


def test_self_gravity_span_and_counters_on_cpu():
    """allpairs_self opens one k3 span (under force when make_allpairs_accel
    calls it) and counts N^2 in k3.pairs; on the CPU the plain version
    runs, so k3.sym_pairs does not move. Tracing off records no span."""
    from parallelnbody_tpu_torch.kernels import launch
    from parallelnbody_tpu_torch.utils import profiling

    pos, mass = (torch.from_numpy(a) for a in _rand(200, seed=8))
    accel = direct_kernels.make_allpairs_accel(SimConfig(softening=0.02),
                                               mass)
    profiling.take_spans()
    before = launch.read_counters()
    with profiling.tracing(True):
        accel(pos)
    grew = {k: v - before[k] for k, v in launch.read_counters().items()}
    spans = profiling.take_spans()
    assert [s.name for s in spans] == ["k3", "force"]  # in order of end
    assert spans[0].parent == spans[1].id
    assert grew["k3.pairs"] == 200 * 200 and grew["k3.sym_pairs"] == 0
    accel(pos)
    assert profiling.take_spans() == []


KW = dict(n=1024, ic="plummer", force="direct_pallas", dt=1e-3,
          softening=0.01, track_potential=False)


@pytest.fixture(scope="module")
def runs():
    """Both packages' force="direct_pallas" Simulation from the same ICs:
    the JAX package runs its Pallas kernel in interpret mode, the port its
    plain version."""
    jsim = japi.Simulation(JaxConfig(**KW))
    j0 = jsim.state
    j1 = jsim.step(1)
    j17 = jsim.step(16)
    ic = japi.init_simulation(JaxConfig(**KW), compute_forces=False)
    st = state_from_numpy({k: np.array(getattr(ic, k))
                           for k in ("pos", "vel", "mass")}, device="cpu")
    cfg = SimConfig(**KW)
    t0 = tapi._fill_initial_forces(cfg, st)
    t1 = tapi.make_step(cfg)(t0)
    t17 = tapi.make_run(cfg, 16)(t1)
    return dict(j0=j0, j1=j1, j17=j17, t0=t0, t1=t1, t17=t17)


def _state_close(t, j, msg):
    for field in ("pos", "vel"):
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)), rtol=1e-4,
                                   err_msg=f"{field} {msg}")
    ja = np.asarray(j.acc)
    np.testing.assert_allclose(t.acc.numpy(), ja, rtol=1e-4,
                               atol=1e-6 * float(np.max(np.abs(ja))),
                               err_msg=f"acc {msg}")


@pytest.mark.parametrize("key,steps", [("0", 0), ("1", 1), ("17", 17)],
                         ids=["t0", "step1", "step16"])
def test_direct_pallas_simulation_matches_jax(runs, key, steps):
    t, j = runs["t" + key], runs["j" + key]
    _state_close(t, j, f"after {steps} steps")
    assert int(t.step) == int(j.step) == steps


def test_default_config_resolves_to_allpairs_on_cuda():
    """SimConfig() (N = 4096, force="auto") picks K3 on a CUDA device and
    the plain direct sum on the CPU, as the JAX package picks its Pallas
    kernel on a TPU."""
    cfg = SimConfig()
    assert cfg.resolve_force("cuda") == "direct_pallas"
    assert cfg.resolve_force("cpu") == "direct"
    assert JaxConfig().resolve_force("tpu") == "direct_pallas"


def test_diagnostics_recompute_potential_through_allpairs():
    """track_potential=False: the hot steps skip the potential and
    Simulation.diagnostics recomputes it through K3's path."""
    sim = Simulation(SimConfig(n=256, force="direct_pallas",
                               track_potential=False), device="cpu")
    sim.step(2)
    assert not bool(torch.any(sim.state.pot != 0))
    d = sim.diagnostics()
    _, pot = direct_accel(sim.state.pos, sim.state.mass, g=1.0,
                          softening=sim.cfg.softening)
    want = 0.5 * float(torch.sum(sim.state.mass * pot))
    np.testing.assert_allclose(d["potential"], want, rtol=1e-5)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_oracle_energy_drift_1000_steps_through_port():
    """tests/test_oracle.py:63 through the port's direct_pallas path on the
    CPU (the plain version of K3): 1000 f32 leapfrog steps from the port's
    own Plummer ICs, energy by the float64 C++ oracle."""
    from parallelnbody_tpu.native import Oracle

    cfg = SimConfig(n=256, ic="plummer", softening=0.05, dt=1e-3,
                    integrator="leapfrog", force="direct_pallas",
                    dtype="float32")
    sim = Simulation(cfg, device="cpu")
    pos0 = sim.state.pos.double().numpy()
    vel0 = sim.state.vel.double().numpy()
    mass = sim.state.mass.double().numpy()
    oracle = Oracle(g=1.0, softening=0.05)

    e0 = oracle.total_energy(pos0, vel0, mass)
    out = sim.step(1000)
    pos1, vel1 = out.pos.double().numpy(), out.vel.double().numpy()
    drift = abs((oracle.total_energy(pos1, vel1, mass) - e0) / e0)
    assert drift < 1e-4, f"energy drift {drift}"

    pos_c, _ = oracle.run(pos0, vel0, mass, dt=1e-3, steps=1000)
    scale = np.max(np.linalg.norm(pos_c, axis=1))
    err = np.max(np.linalg.norm(pos_c - pos1, axis=1)) / scale
    assert err < 0.05, f"trajectory divergence {err}"
