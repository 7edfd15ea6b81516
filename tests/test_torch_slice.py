"""The ported main path end to end against the JAX package: budget
calibration, the t=0 forces, one per-step leapfrog step (bh_accel) and a
rebuild-interval run of 16 steps (two blocks of 8, _make_run_reuse), at
N = 4096 Plummer, leaf 32, theta 0.72, quadrupole, rebuild every 8.

Both packages start from the same JAX ICs, handed to the port as numpy
arrays (state_from_numpy). The JAX side runs on the CPU, where
use_pallas_bh() is False, so its kernels are the jnp versions.

Bounds:
  * positions and velocities: rtol 1e-4. The two packages sum the same f32
    terms in another order; measured at this seed the largest relative
    difference after 17 steps is ~1e-5.
  * accelerations: rtol 1e-4 with an absolute floor of 1e-6 x the largest
    |acc|, since near-zero components carry the f32 rounding of the big
    terms that cancel in them.
  * Lists: here each package builds them from its own tree, so an f32 MAC
    flip is possible (ROADMAP Queue 3). At this seed none happens; the
    count of differing entries is asserted to be 0, so a flip shows up as a
    failure that names the count.
  * rms force error against the direct sum: within 10% of the JAX value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu import api as japi
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.ops import integrators as jint
from parallelnbody_tpu.utils.accuracy import rms_force_error_sample as j_rms
from parallelnbody_tpu_torch import Simulation, SimConfig
from parallelnbody_tpu_torch import api as tapi
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.ops import bh_kernels
from parallelnbody_tpu_torch.state import (make_state, state_from_numpy,
                                           state_to_numpy)
from parallelnbody_tpu_torch.utils.accuracy import \
    rms_force_error_sample as t_rms

torch.set_num_threads(2)

KW = dict(n=4096, ic="plummer", theta=0.72, bh_leaf_size=32,
          force="barnes_hut", bh_multipole=2, bh_rebuild_every=8, dt=1e-3,
          softening=0.01, track_potential=False)
RTOL = 1e-4


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(t, j, msg, acc=False):
    j = _np(j)
    atol = 1e-6 * float(np.max(np.abs(j))) if acc else 0.0
    np.testing.assert_allclose(_np(t), j, rtol=RTOL, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def runs():
    """JAX Simulation and the port, from the same ICs: states at t=0,
    after step(1) and after step(16) more, plus the overflow counts."""
    jsim = japi.Simulation(JaxConfig(**KW))
    j0 = jsim.state
    j1 = jsim.step(1)
    j17 = jsim.step(16)

    ic = japi.init_simulation(JaxConfig(**KW), compute_forces=False)
    st = state_from_numpy({k: np.array(getattr(ic, k))
                           for k in ("pos", "vel", "mass")}, device="cpu")
    cfg = tapi.calibrate_budgets(SimConfig(**KW), st)
    t0 = tapi._fill_initial_forces(cfg, st)
    t1, of1 = tapi.make_step(cfg, report_overflow=True)(t0)
    t17, of17 = tapi.make_run(cfg, 16, report_overflow=True)(t1)
    return dict(jcfg=jsim.cfg, cfg=cfg, ic=ic, j0=j0, j1=j1, j17=j17,
                t0=t0, t1=t1, t17=t17, of1=int(of1), of17=int(of17))


def test_calibrated_budgets_equal(runs):
    assert runs["cfg"].bh_near_budget == runs["jcfg"].bh_near_budget
    assert runs["cfg"].bh_far_budget == runs["jcfg"].bh_far_budget


def test_initial_forces_match(runs):
    _close(runs["t0"].acc, runs["j0"].acc, "acc at t=0", acc=True)


def test_step1_matches(runs):
    t, j = runs["t1"], runs["j1"]
    assert runs["of1"] == 0
    _close(t.pos, j.pos, "pos after step(1)")
    _close(t.vel, j.vel, "vel after step(1)")
    _close(t.acc, j.acc, "acc after step(1)", acc=True)
    assert int(t.step) == int(j.step) == 1


def test_step16_matches(runs):
    t, j = runs["t17"], runs["j17"]
    assert runs["of17"] == 0
    _close(t.pos, j.pos, "pos after step(16)")
    _close(t.vel, j.vel, "vel after step(16)")
    _close(t.acc, j.acc, "acc after step(16)", acc=True)
    assert int(t.step) == int(j.step) == 17
    np.testing.assert_allclose(float(t.time), float(j.time), rtol=1e-6)


def test_lists_from_own_trees_agree(runs):
    """Lists built from each package's own tree of the same positions."""
    ic, cfg = runs["ic"], runs["cfg"]
    jp = jbh._prepare(ic.pos, ic.mass, leaf_size=32, curve="hilbert",
                      multipole_order=2)
    tp = tbh._prepare(torch.from_numpy(np.array(ic.pos)),
                      torch.from_numpy(np.array(ic.mass)), leaf_size=32,
                      curve="hilbert", multipole_order=2)
    n_leaves = jp[5] // 32
    kw = dict(theta=0.72, start_leaf=0, n_slice=n_leaves,
              near_budget=cfg.bh_near_budget, far_budget=cfg.bh_far_budget)
    jl = jbh.build_interaction_lists_octet(
        jp[3], *jbh.traverse(jp[3], 0.72), dtype=jnp.float32, **kw)
    tl = tbh.build_interaction_lists_octet(
        tp[3], *tbh.traverse(tp[3], 0.72), dtype=torch.float32, **kw)
    differing = {name: int((_np(t) != _np(j)).sum()) for name, t, j in
                 zip(("near_idx", "near_valid", "far_keys", "far_valid"),
                     tl, jl)}
    assert differing == dict.fromkeys(differing, 0), differing
    assert int(tl[5]) == int(jl[5]) == 0


def test_rms_within_ten_percent_of_jax(runs):
    t, j = runs["t17"], runs["j17"]
    rj = j_rms(j.pos, j.mass, j.acc, g=1.0, softening=KW["softening"])
    rt = t_rms(t.pos, t.mass, t.acc, g=1.0, softening=KW["softening"])
    assert rj < 2e-3
    assert abs(rt - rj) <= 0.1 * rj, (rt, rj)


def test_bh_accel_with_potential_matches(runs):
    """The per-step force path with the potential on (compute_pot=True)."""
    ic = runs["ic"]
    kw = dict(leaf_size=32, theta=0.72, g=1.0, softening=0.01,
              near_budget=runs["cfg"].bh_near_budget,
              far0_budget=runs["cfg"].bh_far_budget, multipole=2,
              compute_pot=True)
    ja, jpot, jof = jbh.bh_accel(ic.pos, ic.mass, **kw)
    ta, tpot, tof = tbh.bh_accel(torch.from_numpy(np.array(ic.pos)),
                                 torch.from_numpy(np.array(ic.mass)), **kw)
    _close(ta, ja, "acc", acc=True)
    _close(tpot, jpot, "pot")
    assert int(tof) == int(jof) == 0


@pytest.mark.parametrize("k_max,n_steps", [(8, 1), (8, 10), (8, 16),
                                           (8, 17), (4, 9), (1, 5)])
def test_reuse_block_size_equal(k_max, n_steps):
    assert (tapi._reuse_block_size(k_max, n_steps)
            == japi._reuse_block_size(k_max, n_steps))


def test_simulation_on_cpu_with_port_ics():
    """The port's own Plummer ICs (torch.Generator) through Simulation on
    the CPU: the plain kernel versions, nothing launched, no overflow, and
    the force accuracy class of the reference."""
    bh_kernels.reset_launch_counts()
    sim = Simulation(SimConfig(**KW), device="cpu")
    sim.step(1)
    s = sim.step(9)
    assert int(s.step) == 10 and int(sim.overflow) == 0
    for t in (s.pos, s.vel, s.acc):
        assert bool(torch.isfinite(t).all())
    assert bh_kernels.LAUNCHES == {"near_field": 0, "near_field_window": 0,
                                   "near_field_table": 0, "far_octet": 0,
                                   "far_gather": 0}
    assert t_rms(s.pos, s.mass, s.acc, g=1.0, softening=0.01) < 2e-3
    d = sim.diagnostics()
    assert d["step"] == 10 and d["potential"] < 0 < d["kinetic"]


def test_simulation_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(SimConfig(**KW), device="cuda")


@pytest.mark.parametrize("entry", ["init_simulation", "prepare_simulation",
                                   "make_state", "state_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """Without a device argument the entry points run on the card; where
    there is none they raise, and do not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks its absence")
    n = 64
    arrays = {"pos": np.zeros((n, 3), np.float32),
              "vel": np.zeros((n, 3), np.float32),
              "mass": np.full(n, 1.0 / n, np.float32)}
    call = {"init_simulation": lambda: tapi.init_simulation(
                SimConfig(**KW)),
            "prepare_simulation": lambda: tapi.prepare_simulation(
                SimConfig(**KW)),
            "make_state": lambda: make_state(arrays["pos"], arrays["vel"],
                                             arrays["mass"]),
            "state_from_numpy": lambda: state_from_numpy(arrays)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("name", ["euler_semi_implicit", "euler", "leapfrog",
                                  "dkd", "yoshida4", "rk4"])
def test_integrators_match(name):
    """Each integrator with the direct sum, f64, 5 steps, both packages."""
    from parallelnbody_tpu.ops.direct import direct_accel as j_direct
    from parallelnbody_tpu_torch.ops.direct import direct_accel as t_direct
    from parallelnbody_tpu_torch.ops.integrators import get_integrator

    rng = np.random.default_rng(5)
    pos = rng.normal(size=(64, 3))
    vel = 0.1 * rng.normal(size=(64, 3))
    mass = rng.uniform(0.5, 1.5, 64) / 64
    jf = jint.get_integrator(name)
    tf = get_integrator(name)

    def jacc(p):
        return j_direct(p, jnp.asarray(mass), g=1.0, softening=0.05)

    def tacc(p):
        return t_direct(p, torch.from_numpy(mass), g=1.0, softening=0.05)

    js = (jnp.asarray(pos), jnp.asarray(vel), *jacc(jnp.asarray(pos)))
    ts = (torch.from_numpy(pos), torch.from_numpy(vel),
          *tacc(torch.from_numpy(pos)))
    for _ in range(5):
        js = jf(jacc, *js, 0.01)
        ts = tf(tacc, *ts, 0.01)
    for t, j, label in zip(ts, js, ("pos", "vel", "acc", "pot")):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-10, atol=1e-12,
                                   err_msg=label)


def test_diagnostics_match(runs):
    """energy.diagnostics on the same state (f32) in both packages. The
    momentum norm of a centred sphere is a cancellation near 1e-8, so an
    absolute floor of 1e-7 (f32 rounding of its O(0.1) terms) applies."""
    from parallelnbody_tpu.ops.energy import diagnostics as j_diag
    from parallelnbody_tpu_torch.ops.energy import diagnostics as t_diag

    j = runs["j0"]
    t = state_from_numpy({k: np.array(getattr(j, k)) for k in
                          ("pos", "vel", "mass", "acc", "pot", "time",
                           "step")}, device="cpu")
    jd, td = j_diag(j), t_diag(t)
    assert set(jd) == set(td)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_state_numpy_round_trip(runs):
    """A JAX state carried into the port and back as numpy arrays."""
    j = runs["j17"]
    arrays = {k: np.array(getattr(j, k)) for k in
              ("pos", "vel", "mass", "acc", "pot", "time", "step")}
    back = state_to_numpy(state_from_numpy(arrays, device="cpu"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
