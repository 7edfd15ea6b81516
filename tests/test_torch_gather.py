"""The gather far field (bh_far_mode="gather", dense refinement) in the port
against the JAX package: K4's plain version against `far_field_pallas` (the
Pallas kernel in interpret mode) on the same lists, the gather lists bit for
bit on the JAX tree, calibrated budgets, gather against octet forces, and a
Simulation step from the same ICs.

Tolerances:
  * K4 plain against Pallas: rtol 2e-4, atol 2e-5 (the kernel bound of
    tests/test_bh.py; the same f32 terms in another order);
  * gather against octet forces: relative norm < 1e-5, the bound of
    tests/test_bh.py:752 (the same interaction set, another summation);
  * Simulation: rtol 1e-4 with an absolute floor on accelerations of
    1e-6 x the largest |acc| (the bounds of tests/test_torch_slice.py).
Lists, overflow counts and budgets must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu import api as japi
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.ops.pallas_bh import far_field_pallas
from parallelnbody_tpu_torch import Simulation, SimConfig
from parallelnbody_tpu_torch import api as tapi
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.ops import bh_kernels
from parallelnbody_tpu_torch.state import state_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
LEAF = 32


def _plummer_np(n, seed):
    cfg = JaxConfig(n=n, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(seed), cfg)
    return np.array(pos), np.array(mass)


def _to_torch_tree(jt):
    conv = lambda level: (None if level is None  # noqa: E731
                          else torch.from_numpy(np.array(level)))
    return tbh.BHTree(*(tuple(conv(x) for x in getattr(jt, f))
                        for f in ("com", "mass", "radius", "quad")))


def _t(a):
    return torch.from_numpy(np.array(a))


LIST_NAMES = ("near_idx", "near_valid", "far0_idx", "far0_valid", "up_idx",
              "up_valid", "nodes_up", "leaf_nodes", "overflow")


@pytest.fixture(scope="module", params=[(4096, 11), (3000, 4)],
                ids=["n4096", "n3000-padded"])
def trees(request):
    """(JAX tree, the same tree in torch, sorted positions as numpy)."""
    n, seed = request.param
    pos, mass = _plummer_np(n, seed)
    pos_s, _, _, jt, _, _ = jbh._prepare(
        jnp.asarray(pos), jnp.asarray(mass), leaf_size=LEAF, curve="hilbert",
        multipole_order=2)
    return jt, _to_torch_tree(jt), np.array(pos_s)


def _gather_lists(jt, tt, near_b, far_b, theta=0.72):
    n_leaves = jt.com[0].shape[0]
    kw = dict(theta=theta, start_leaf=0, n_slice=n_leaves,
              near_budget=near_b, far0_budget=far_b)
    jl = jbh.build_interaction_lists(jt, *jbh.traverse(jt, theta),
                                     dtype=jnp.float32, **kw)
    tl = tbh.build_interaction_lists(tt, *tbh.traverse(tt, theta),
                                     dtype=torch.float32, **kw)
    return jl, tl


@pytest.mark.parametrize("budgets", [(4096, 4096), (128, 256), (2, 8)],
                         ids=["wide", "calibrated", "overflow"])
def test_gather_lists_equal(trees, budgets):
    jt, tt, _ = trees
    jl, tl = _gather_lists(jt, tt, *budgets)
    for name, t, j in zip(LIST_NAMES, tl, jl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert tl[0].dtype == tl[2].dtype == tl[4].dtype == torch.int32
    assert (int(tl[8]) > 0) == (budgets == (2, 8))


@pytest.fixture(scope="module")
def kernel_lists():
    """Gather lists at N = 4096, leaf 16 (256 leaves, levels 256/32/4/1),
    theta 0.72, where both far classes are populated (~500 upper and ~38000
    leaf entries), as numpy arrays: (targets, [(table, idx, valid)] for the
    upper and the leaf class)."""
    pos, mass = _plummer_np(4096, 5)
    pos_s, _, _, jt, _, n_pad = jbh._prepare(
        jnp.asarray(pos), jnp.asarray(mass), leaf_size=16, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // 16
    jl = jbh.build_interaction_lists(
        jt, *jbh.traverse(jt, 0.72), theta=0.72, start_leaf=0,
        n_slice=n_leaves, near_budget=n_leaves, far0_budget=n_leaves,
        dtype=jnp.float32)
    classes = [tuple(np.array(jl[i]) for i in (6, 4, 5)),
               tuple(np.array(jl[i]) for i in (7, 2, 3))]
    assert all(int(valid.sum()) > 0 for _, _, valid in classes)
    return np.array(pos_s).reshape(n_leaves, 16, 3), classes


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
def test_far_gather_plain_matches_pallas(kernel_lists, softening, compute_pot,
                                         quad):
    """Both far classes of the gather path (upper nodes, accepted leaves),
    front-packed, monopole and quadrupole rows."""
    tgt, classes = kernel_lists
    for table, idx, valid in classes:
        table = np.ascontiguousarray(table[:, :9 if quad else 4])
        ja, jp, _ = far_field_pallas(
            jnp.asarray(tgt), jnp.asarray(table), jnp.asarray(idx),
            jnp.asarray(valid), 1.5, softening, softening == 0.0,
            interpret=True, compute_pot=compute_pot)
        ta, tp = bh_kernels.far_gather(
            _t(tgt), _t(table), _t(idx), _t(valid), g=1.5,
            softening=softening, compute_pot=compute_pot)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                                   atol=ATOL)
        assert bool(torch.any(tp != 0)) == compute_pot


def test_far_gather_scattered_mask_matches_pallas(trees):
    """front_packed=False: a raw scattered mask (a random third of the
    entries of full-width rows over the leaf table), every entry walked and
    masked."""
    jt, _, pos_s = trees
    n_leaves = jt.com[0].shape[0]
    tgt = pos_s.reshape(n_leaves, LEAF, 3)
    table = np.array(jbh._node_table(jt, 0, jnp.float32))
    rng = np.random.default_rng(8)
    idx = np.broadcast_to(np.arange(n_leaves, dtype=np.int32),
                          (n_leaves, n_leaves)).copy()
    valid = rng.uniform(size=(n_leaves, n_leaves)) < 1 / 3
    ja, jp, _ = far_field_pallas(
        jnp.asarray(tgt), jnp.asarray(table), jnp.asarray(idx),
        jnp.asarray(valid), 1.0, 0.02, False, interpret=True,
        front_packed=False)
    ta, tp = bh_kernels.far_gather(_t(tgt), _t(table), _t(idx), _t(valid),
                                   g=1.0, softening=0.02, front_packed=False)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)


def test_upper_far_list_not_front_packed():
    """tests/test_bh.py:394 through the port: a single valid far source at a
    high node id behind a scattered mask, budget above the chunk size, must
    not be skipped."""
    rng = np.random.default_rng(3)
    tgt = torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 8, 3)))
    n_nodes = 700  # > the 512-entry chunk of the plain version
    nodes = torch.zeros((n_nodes, 4), dtype=torch.float64)
    nodes[600, :3] = torch.tensor([2.0, 0.0, 0.0])
    nodes[600, 3] = 5.0
    idx = torch.arange(n_nodes, dtype=torch.int32)[None].expand(1, n_nodes)
    valid = torch.zeros((1, n_nodes), dtype=torch.bool)
    valid[0, 600] = True
    acc, _ = bh_kernels.far_gather(tgt, nodes, idx.contiguous(), valid,
                                   g=1.0, softening=0.0, front_packed=False)
    assert float(torch.min(torch.abs(acc[:, 0]))) > 0.5


def test_gather_budget_requirements_equal():
    pos, mass = _plummer_np(4096, 7)
    kw = dict(n=4096, theta=0.72, bh_leaf_size=32, force="barnes_hut",
              bh_far_mode="gather")
    jr = jbh.measure_budget_requirements(jnp.asarray(pos), jnp.asarray(mass),
                                         JaxConfig(**kw))
    tr = tbh.measure_budget_requirements(torch.from_numpy(pos),
                                         torch.from_numpy(mass),
                                         SimConfig(**kw))
    assert tr == jr
    assert tr["refine"] == "dense" and tr["far_mode"] == "gather"


def _overflow(state, cfg, **change):
    cfg = cfg.replace(**change)
    _, _, of = tbh.bh_accel(
        state.pos, state.mass, leaf_size=cfg.resolve_bh_leaf_size(),
        theta=cfg.theta, g=cfg.g, softening=cfg.softening,
        near_budget=cfg.bh_near_budget, far0_budget=cfg.bh_far_budget,
        multipole=cfg.bh_multipole, far_mode="gather")
    return int(of)


def test_gather_requirements_exact():
    """Zero overflow at exactly the measured gather maxima, overflow one
    below (the dense cases of tests/test_calibration.py, gather)."""
    cfg = SimConfig(n=2048, ic="plummer", theta=0.72, bh_leaf_size=32,
                    force="barnes_hut", bh_far_mode="gather")
    state = tapi.init_simulation(cfg, "cpu", compute_forces=False)
    req = tbh.measure_budget_requirements(state.pos, state.mass, cfg)
    exact = cfg.replace(bh_near_budget=req["near_max"],
                        bh_far_budget=req["far_max"])
    assert _overflow(state, exact) == 0
    assert _overflow(state, exact, bh_near_budget=req["near_max"] - 1) > 0
    assert _overflow(state, exact, bh_far_budget=req["far_max"] - 1) > 0


@pytest.mark.parametrize("multipole", [1, 2], ids=["mono", "quad"])
def test_octet_far_matches_gather(multipole):
    """tests/test_bh.py:752 (dense) in the port: the octet and gather far
    modes evaluate the same interaction set, so forces and potentials agree
    to f32 summation order."""
    pos, mass = _plummer_np(4096, 4)
    kw = dict(leaf_size=32, theta=0.6, g=1.0, softening=0.02,
              near_budget=128, far0_budget=512, multipole=multipole,
              refine="dense")
    ag, pg, og = tbh.bh_accel(torch.from_numpy(pos), torch.from_numpy(mass),
                              far_mode="gather", **kw)
    ao, po, oo = tbh.bh_accel(torch.from_numpy(pos), torch.from_numpy(mass),
                              far_mode="octet", **kw)
    assert int(og) == 0 and int(oo) == 0
    assert float(torch.linalg.norm(ag - ao) / torch.linalg.norm(ag)) < 1e-5
    assert float(torch.linalg.norm(pg - po) / torch.linalg.norm(pg)) < 1e-5


KW = dict(n=4096, ic="plummer", theta=0.72, bh_leaf_size=32,
          force="barnes_hut", bh_multipole=2, bh_far_mode="gather", dt=1e-3,
          softening=0.01, track_potential=False)


@pytest.fixture(scope="module")
def runs():
    """JAX Simulation and the port with the gather far field, from the same
    ICs: t = 0 and after step(1), plus budgets and overflow."""
    jsim = japi.Simulation(JaxConfig(**KW))
    j0 = jsim.state
    j1 = jsim.step(1)
    ic = japi.init_simulation(JaxConfig(**KW), compute_forces=False)
    st = state_from_numpy({k: np.array(getattr(ic, k))
                           for k in ("pos", "vel", "mass")}, device="cpu")
    bh_kernels.reset_launch_counts()
    cfg = tapi.calibrate_budgets(SimConfig(**KW), st)
    t0 = tapi._fill_initial_forces(cfg, st)
    t1, of1 = tapi.make_step(cfg, report_overflow=True)(t0)
    return dict(jcfg=jsim.cfg, cfg=cfg, j0=j0, j1=j1, t0=t0, t1=t1,
                of1=int(of1), launches=dict(bh_kernels.LAUNCHES))


def test_gather_calibrated_budgets_equal(runs):
    assert runs["cfg"].bh_near_budget == runs["jcfg"].bh_near_budget
    assert runs["cfg"].bh_far_budget == runs["jcfg"].bh_far_budget


@pytest.mark.parametrize("key", ["0", "1"], ids=["t0", "step1"])
def test_gather_step_matches_jax(runs, key):
    t, j = runs["t" + key], runs["j" + key]
    for field in ("pos", "vel"):
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)), rtol=1e-4,
                                   err_msg=field)
    ja = np.asarray(j.acc)
    np.testing.assert_allclose(t.acc.numpy(), ja, rtol=1e-4,
                               atol=1e-6 * float(np.max(np.abs(ja))),
                               err_msg="acc")
    assert runs["of1"] == 0
    assert runs["launches"] == {"near_field": 0, "far_octet": 0,
                                "far_gather": 0}


def test_gather_simulation_steps_per_step_on_cpu():
    """Simulation with the gather far mode: step(k) rebuilds every step (no
    list reuse, as in the JAX package), clips nothing and stays finite."""
    cfg = SimConfig(**{**KW, "n": 2048})
    assert not tapi._reuse_eligible(cfg, 4)
    sim = Simulation(cfg, device="cpu")
    s = sim.step(4)
    assert int(s.step) == 4 and int(sim.overflow) == 0
    assert bool(torch.isfinite(s.acc).all())
