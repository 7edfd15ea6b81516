"""Budget calibration in the port (api.calibrate_budgets, ops/bh.py
measure_budget_requirements), on the port's own Plummer ICs: the measured
maxima are the true list requirements of the dense-octet path, an untuned
fresh IC runs overflow-free, and explicit budgets are kept. Mirrors the
dense cases of tests/test_calibration.py."""

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import (calibrate_budgets, init_simulation,
                                         make_run, prepare_simulation)
from parallelnbody_tpu_torch.ops.bh import (bh_accel,
                                            measure_budget_requirements)

torch.set_num_threads(2)


def _cfg(**kw):
    base = dict(ic="plummer", dt=1e-3, softening=0.01, theta=0.72,
                force="barnes_hut", integrator="leapfrog")
    return SimConfig(**{**base, **kw})


def _overflow(state, cfg):
    _, _, of = bh_accel(
        state.pos, state.mass, leaf_size=cfg.resolve_bh_leaf_size(),
        theta=cfg.theta, g=cfg.g, softening=cfg.softening,
        near_budget=cfg.resolve_bh_near_budget(),
        far0_budget=cfg.resolve_bh_far_budget(), curve=cfg.bh_curve,
        multipole=cfg.bh_multipole, max_levels=cfg.bh_max_levels,
        refine=cfg.resolve_bh_refine(), far_mode=cfg.bh_far_mode,
        sections=cfg.bh_sections)
    return int(of)


def test_requirements_exact_dense():
    """Zero overflow at exactly the measured maxima, overflow one below."""
    cfg = _cfg(n=2048, bh_leaf_size=32)
    state = init_simulation(cfg, compute_forces=False)
    req = measure_budget_requirements(state.pos, state.mass, cfg)
    assert req["refine"] == "dense" and req["far_mode"] == "octet"
    exact = cfg.replace(bh_near_budget=req["near_max"],
                        bh_far_budget=req["far_max"])
    assert _overflow(state, exact) == 0
    assert _overflow(state, exact.replace(
        bh_near_budget=req["near_max"] - 1)) > 0
    assert _overflow(state, exact.replace(
        bh_far_budget=req["far_max"] - 1)) > 0


def test_untuned_fresh_ic_runs_overflow_free():
    """Every budget at 0 = auto, odd N (padding): calibration, then a
    rebuild-interval run with zero overflow."""
    cfg = _cfg(n=3000, bh_leaf_size=32, bh_rebuild_every=2)
    assert cfg.bh_near_budget == 0 and cfg.bh_far_budget == 0
    ccfg, state = prepare_simulation(cfg)
    assert ccfg.bh_near_budget > 0 and ccfg.bh_far_budget > 0
    out, of = make_run(ccfg, 4, report_overflow=True)(state)
    assert int(of) == 0
    assert bool(torch.isfinite(out.pos).all())


def test_explicit_budgets_respected():
    cfg = _cfg(n=2048, bh_leaf_size=32, bh_near_budget=77, bh_far_budget=99)
    state = init_simulation(cfg, compute_forces=False)
    out = calibrate_budgets(cfg, state)
    assert out.bh_near_budget == 77 and out.bh_far_budget == 99


def test_non_bh_noop():
    cfg = _cfg(n=512, force="direct")
    state = init_simulation(cfg, compute_forces=False)
    assert calibrate_budgets(cfg, state) is cfg
