"""Sections, staged budget calibration and staged runs: the port against
the JAX package.

Sectioned results (bh_sections > 1: target windows evaluated one after the
other) are held bitwise against unsectioned ones, as tests/test_bh.py:599
and tests/test_reuse.py:126 hold them. The staged calibration must equal
the JAX package's on every key and budget (tests/test_calibration.py:59,79).
Runs start from the JAX ICs and are held at rtol 1e-4 (positions,
velocities) with an absolute floor of 1e-6 x max|acc| on accelerations, the
bounds of tests/test_torch_slice.py; forces from raw positions in f64 at
rtol 1e-9 / atol 1e-12 (tests/test_bh.py:579).
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
from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch import api as tapi
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.state import state_from_numpy

torch.set_num_threads(2)

F64 = dict(rtol=1e-9, atol=1e-12)


def _plummer_np(n, seed, dtype="float64"):
    cfg = JaxConfig(n=n, ic="plummer", dtype=dtype)
    pos, _, mass = get_ic("plummer")(jax.random.key(seed), cfg)
    return np.array(pos), np.array(mass)


def _accel_kw(**kw):
    return dict(leaf_size=32, theta=0.6, g=1.0, softening=0.02,
                near_budget=512, far0_budget=1024, multipole=2) | kw


@pytest.mark.parametrize("far_mode", ["octet", "gather"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sectioned_evaluation_matches_unsectioned(far_mode, dtype):
    """bh_sections > 1 (tests/test_bh.py:599): each target window runs the
    same windowed traversal and lists, so forces, potentials AND the
    overflow counter are bitwise those of the unsectioned evaluation, at
    clean and at clipping budgets."""
    pos, mass = (torch.from_numpy(a) for a in _plummer_np(8192, 3, dtype))
    kw = _accel_kw(refine="staged", far_mode=far_mode,
                   far0_budget=1024 if far_mode == "octet" else 4096)
    a1, p1, of1 = tbh.bh_accel(pos, mass, sections=1, **kw)
    a4, p4, of4 = tbh.bh_accel(pos, mass, sections=4, **kw)
    assert int(of1) == int(of4) == 0
    assert torch.equal(a1, a4) and torch.equal(p1, p4)
    _, _, ot1 = tbh.bh_accel(pos, mass, sections=1, **(kw | {"near_budget": 8}))
    _, _, ot4 = tbh.bh_accel(pos, mass, sections=4, **(kw | {"near_budget": 8}))
    assert int(ot1) == int(ot4) > 0


# ------------------------------------------------------------ calibration
def _cal_cfg(**kw):
    return dict(ic="plummer", dt=1e-3, softening=0.01, theta=0.72,
                force="barnes_hut", integrator="leapfrog", n=8192,
                bh_leaf_size=16, bh_refine="staged") | kw


def _state_np(cfg):
    st = japi.init_simulation(JaxConfig(**cfg), compute_forces=False)
    return st, state_from_numpy({k: np.array(getattr(st, k))
                                 for k in ("pos", "vel", "mass")},
                                device="cpu")


@pytest.mark.parametrize("change", [{}, {"bh_sections": 2},
                                    {"bh_far_mode": "gather"}],
                         ids=["staged", "sectioned", "gather"])
def test_measure_budget_requirements_staged_equal(change):
    """tests/test_calibration.py:59,79 in the port: the staged (and
    sectioned) requirements equal the JAX package's on every key."""
    cfg = _cal_cfg(**change)
    jst, tst = _state_np(cfg)
    jr = jbh.measure_budget_requirements(jst.pos, jst.mass, JaxConfig(**cfg))
    tr = tbh.measure_budget_requirements(tst.pos, tst.mass, SimConfig(**cfg))
    assert tr == jr
    assert tr["refine"] == "staged"
    assert tr["sections"] == change.get("bh_sections", 1)


def test_staged_requirements_exact():
    """Zero overflow at exactly the measured maxima; one below on the near,
    far or level-1 candidate budget overflows (tests/test_calibration.py:59)."""
    cfg = SimConfig(**_cal_cfg())
    state = tapi.init_simulation(cfg, "cpu", compute_forces=False)
    req = tbh.measure_budget_requirements(state.pos, state.mass, cfg)
    exact = cfg.replace(bh_near_budget=req["near_max"],
                        bh_far_budget=req["far_max"],
                        bh_cand2_budget=req["cand2_max"],
                        bh_cand_budget=req["cand1_max"])

    def overflow(c):
        return int(tbh.bh_accel(
            state.pos, state.mass, leaf_size=16, theta=c.theta,
            softening=c.softening, near_budget=c.bh_near_budget,
            far0_budget=c.bh_far_budget, multipole=c.bh_multipole,
            refine="staged",
            cand_budgets=(c.bh_cand2_budget, c.bh_cand_budget))[2])

    assert overflow(exact) == 0
    for field, key in (("bh_near_budget", "near_max"),
                       ("bh_far_budget", "far_max"),
                       ("bh_cand_budget", "cand1_max")):
        assert overflow(exact.replace(**{field: max(1, req[key] - 1)})) > 0


def test_calibrate_budgets_staged_equals_jax():
    """api.calibrate_budgets gives the JAX package's four budgets, the
    candidate budgets padded to multiples of 64."""
    cfg = _cal_cfg()
    jst, tst = _state_np(cfg)
    jc = japi.calibrate_budgets(JaxConfig(**cfg), jst)
    tc = tapi.calibrate_budgets(SimConfig(**cfg), tst)
    for f in ("bh_near_budget", "bh_far_budget", "bh_cand2_budget",
              "bh_cand_budget"):
        assert getattr(tc, f) == getattr(jc, f) > 0, f
    assert tc.bh_cand2_budget % 64 == 0 and tc.bh_cand_budget % 64 == 0


# ---------------------------------------------------------------- the runs
def test_sectioned_reuse_bitwise():
    """tests/test_reuse.py:126 in the port: at static positions the
    windowed plan and sectioned evaluation reproduce the per-step
    sectioned run bitwise, with zero overflow."""
    cfg = SimConfig(n=4096, force="barnes_hut", theta=0.72, dt=1e-12,
                    softening=0.01, ic="plummer", bh_leaf_size=64,
                    bh_refine="staged", bh_sections=2, bh_near_budget=64,
                    bh_far_budget=256, bh_rebuild_every=1)
    state = tapi.init_simulation(cfg, "cpu")
    s1, of1 = tapi.make_run(cfg, 6, report_overflow=True)(state)
    s2, of2 = tapi.make_run(cfg.replace(bh_rebuild_every=3), 6,
                            report_overflow=True)(state)
    assert tapi._reuse_eligible(cfg.replace(bh_rebuild_every=3), 6)
    assert int(of1) == 0 and int(of2) == 0
    for f in ("pos", "vel", "acc"):
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f


def test_sectioned_plan_equals_unsectioned_plan():
    """bh_plan_lists in 4 windows: the full-width lists and overflow of the
    one-window build, with one work item set and launch order per window
    (None on the CPU) and an evaluation bitwise the unsectioned one's."""
    pos, mass = _plummer_np(8192, 9, "float32")
    pos_s, mass_s, _, tree, _, n_pad = tbh._prepare(
        torch.from_numpy(pos), torch.from_numpy(mass), leaf_size=32,
        curve="hilbert", multipole_order=2)
    kw = dict(theta=0.72, near_budget=128, far_budget=256, refine="staged",
              cand_budgets=(64, 256), dtype=torch.float32, leaf_size=32)
    one = tbh.bh_plan_lists(tree, sections=1, **kw)
    four = tbh.bh_plan_lists(tree, sections=4, **kw)
    for a, b in zip(one[:5], four[:5]):
        assert torch.equal(a, b)
    assert four.near_work == (None,) * 4 and four.far_order == (None,) * 4
    ekw = dict(leaf_size=32, g=1.0, softening=0.01, multipole=2,
               max_levels=12, compute_pot=True, n_live=8192)
    e1 = tbh.bh_eval_lists(pos_s, mass_s, one, sections=1, **ekw)
    e4 = tbh.bh_eval_lists(pos_s, mass_s, four, sections=4, **ekw)
    assert all(torch.equal(a, b) for a, b in zip(e1, e4))
    with pytest.raises(ValueError, match="windows"):
        tbh.bh_eval_lists(pos_s, mass_s, four, sections=2, **ekw)


@pytest.fixture(scope="module")
def staged_runs():
    """JAX Simulation and the port on a staged config from the same ICs:
    step(1), then step(16) at the rebuild interval 8."""
    kw = dict(n=4096, ic="plummer", theta=0.72, bh_leaf_size=16,
              force="barnes_hut", bh_multipole=2, bh_rebuild_every=8,
              dt=1e-3, softening=0.01, track_potential=False,
              bh_refine="staged")
    jsim = japi.Simulation(JaxConfig(**kw))
    j1 = jsim.step(1)
    j17 = jsim.step(16)
    jst, tst = _state_np(kw)
    cfg = tapi.calibrate_budgets(SimConfig(**kw), tst)
    t0 = tapi._fill_initial_forces(cfg, tst)
    t1, of1 = tapi.make_step(cfg, report_overflow=True)(t0)
    t17, of17 = tapi.make_run(cfg, 16, report_overflow=True)(t1)
    return dict(jcfg=jsim.cfg, cfg=cfg, j1=j1, j17=j17, t1=t1, t17=t17,
                of=(int(of1), int(of17)))


def test_staged_simulation_matches_jax(staged_runs):
    """A staged step(1) and step(16) at the rebuild interval against the
    JAX package's Simulation: positions and velocities at rtol 1e-4,
    accelerations with an absolute floor of 1e-6 x max|acc| (the bounds
    of tests/test_torch_slice.py), calibrated budgets equal, no overflow."""
    r = staged_runs
    assert r["of"] == (0, 0)
    for f in ("bh_near_budget", "bh_far_budget", "bh_cand2_budget",
              "bh_cand_budget"):
        assert getattr(r["cfg"], f) == getattr(r["jcfg"], f), f
    for t, j in ((r["t1"], r["j1"]), (r["t17"], r["j17"])):
        np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos),
                                   rtol=1e-4)
        np.testing.assert_allclose(t.vel.numpy(), np.asarray(j.vel),
                                   rtol=1e-4)
        ja = np.asarray(j.acc)
        np.testing.assert_allclose(t.acc.numpy(), ja, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(ja).max()))
        assert int(t.step) == int(j.step)


def test_staged_runs_through_simulation_on_cpu():
    """The auto refinement turns staged from 8192 leaves; Simulation runs
    a staged config per step and at the rebuild interval, with calibrated
    candidate budgets and no overflow."""
    assert SimConfig(n=8192, bh_leaf_size=1).resolve_bh_refine() == "staged"
    assert SimConfig(n=8192, bh_leaf_size=2).resolve_bh_refine() == "dense"
    cfg = SimConfig(n=8192, ic="plummer", theta=0.72, bh_leaf_size=16,
                    force="barnes_hut", dt=1e-3, softening=0.01,
                    track_potential=False, bh_rebuild_every=4,
                    bh_refine="staged")
    sim = tapi.Simulation(cfg, device="cpu")
    assert sim.cfg.bh_cand2_budget > 0 and sim.cfg.bh_cand_budget > 0
    sim.step(1)
    s = sim.step(4)
    assert int(s.step) == 5 and int(sim.overflow) == 0
    assert bool(torch.isfinite(s.acc).all())


@pytest.mark.parametrize("sections,n_leaves,refine,want", [
    (0, 8192, "staged", 1), (0, 65536, "staged", 1), (0, 131072, "staged", 1),
    (0, 262144, "staged", 4), (0, 524288, "staged", 8), (8, 131072, "staged", 8),
    (6, 4096, "staged", 4), (64, 32, "staged", 32), (4, 4096, "dense", 1)])
def test_resolve_sections(sections, n_leaves, refine, want):
    """The auto stays unsectioned up to 131072 leaves (32M at leaf 256, the
    largest run measured unsectioned on the card), then windows of 65536
    rows; explicit counts are clamped to a power of two that divides
    n_leaves; dense refinement never sections."""
    assert tbh.resolve_sections(sections, n_leaves, refine) == want


@pytest.fixture(scope="module")
def plummer_f32():
    """{n: (pos, mass)} float32 Plummer spheres from the JAX ICs."""
    return {n: tuple(torch.from_numpy(a) for a in _plummer_np(n, 5,
                                                             "float32"))
            for n in (256, 8192)}


@pytest.mark.parametrize("n", [256, 8192], ids=["2-levels", "4-levels"])
@pytest.mark.parametrize("sections", [0, 1, 4])
@pytest.mark.parametrize("far_mode", ["octet", "gather"])
@pytest.mark.parametrize("refine", ["dense", "staged"])
def test_setup_is_each_resolution_it_replaces(plummer_f32, refine, far_mode,
                                              sections, n):
    """BHSetup.of(cfg) resolves as the separate rules did (plan_tree,
    resolve_refine, resolve_far_mode, resolve_sections; a staged config on
    a tree of fewer than 3 levels falls back to dense and one window), its
    levels are the built tree's, and BHSetup.make from bh_accel's keywords
    and BHSetup.of at the tree's leaf count give the same settings."""
    cfg = SimConfig(n=n, force="barnes_hut", bh_leaf_size=32, theta=0.6,
                    bh_multipole=2, bh_refine=refine, bh_far_mode=far_mode,
                    bh_sections=sections)
    setup = tbh.BHSetup.of(cfg)
    leaf = cfg.resolve_bh_leaf_size()
    near, far = cfg.resolve_bh_near_budget(), cfg.resolve_bh_far_budget()
    n_leaves, n_pad, n_levels = tbh.plan_tree(n, leaf, cfg.bh_max_levels)
    want_refine, cands = tbh.resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        n_levels, near, far)
    assert (setup.leaf, setup.n_leaves, setup.n_pad, setup.n_levels) == (
        leaf, n_leaves, n_pad, n_levels)
    assert (setup.refine, setup.cands) == (want_refine, cands)
    assert setup.far_mode == tbh.resolve_far_mode(far_mode, want_refine)
    assert setup.sections == tbh.resolve_sections(sections, n_leaves,
                                                  want_refine)
    assert setup.stop == (1 if want_refine == "dense" else 2)
    assert setup.budgets() == {"near": near, "far": far, "cand2": cands[0],
                               "cand1": cands[1]}
    assert (setup.theta, setup.g, setup.softening, setup.multipole,
            setup.max_levels, setup.curve, setup.compute_pot) == (
        cfg.theta, cfg.g, cfg.softening, cfg.bh_multipole,
        cfg.bh_max_levels, cfg.bh_curve, cfg.track_potential)
    assert (want_refine == "staged") == (refine == "staged" and n == 8192)
    pos, mass = plummer_f32[n]
    tree = tbh._prepare(pos, mass, leaf_size=leaf, curve=cfg.bh_curve,
                        multipole_order=2)[3]
    assert tree.n_levels == setup.n_levels
    assert tree.com[0].shape[0] == setup.n_leaves
    assert tbh.BHSetup.of(cfg, n_leaves=setup.n_leaves) == setup
    assert tbh.BHSetup.make(
        n, leaf_size=leaf, theta=cfg.theta, g=cfg.g,
        softening=cfg.softening, near_budget=near, far0_budget=far,
        curve=cfg.bh_curve, multipole=2, max_levels=cfg.bh_max_levels,
        compute_pot=cfg.track_potential, refine=cfg.resolve_bh_refine(),
        cand_budgets=(0, 0), far_mode=far_mode, sections=sections) == setup


@pytest.mark.parametrize("sections", [1, 4])
@pytest.mark.parametrize("refine", ["dense", "staged"])
def test_accel_is_plan_then_eval(plummer_f32, refine, sections):
    """bh_accel (octet far field) is, bit for bit, the rebuild block's
    pipeline at the same positions: _prepare, bh_plan_lists and
    bh_eval_lists in as many windows, unsorted; the overflow is the plan's.
    (Dense lists are evaluated in one window by bh_accel; a plan in 4
    windows holds the same lists.)"""
    pos, mass = plummer_f32[8192]
    cands = (64, 256) if refine == "staged" else (0, 0)
    acc, pot, of = tbh.bh_accel(
        pos, mass, leaf_size=32, theta=0.6, softening=0.02, near_budget=512,
        far0_budget=512, multipole=2, refine=refine, cand_budgets=cands,
        far_mode="octet", sections=sections)
    pos_s, mass_s, perm, tree, n, _ = tbh._prepare(
        pos, mass, leaf_size=32, curve="hilbert", multipole_order=2)
    plan = tbh.bh_plan_lists(
        tree, theta=0.6, near_budget=512, far_budget=512, refine=refine,
        cand_budgets=cands, dtype=torch.float32, leaf_size=32,
        sections=sections)
    a_s, p_s = tbh.bh_eval_lists(
        pos_s, mass_s, plan, leaf_size=32, g=1.0, softening=0.02,
        multipole=2, max_levels=12, compute_pot=True, n_live=n,
        sections=sections)
    got_a, got_p = tbh._unsort(a_s, p_s, perm, n)
    assert int(plan.overflow) == int(of) == 0
    assert torch.equal(got_a, acc) and torch.equal(got_p, pot)
