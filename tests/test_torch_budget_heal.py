"""Calibrated list budgets that clip are healed inside the step callables
(ops/bh.py ListHeal, api.make_step / make_run): the lists are built again at
grown budgets before any force is taken from them, so the state is the one
a run at budgets that clip nothing gives, and the overflow is 0. Budgets
the caller set are never grown. A run that never clips is the run without
the heal, list for list and bit for bit.

Plummer spheres of the benchmark's sampler (benchmark/inputs/plummer.py),
N = 4096 at leaf 16: 256 leaves, dense lists or staged lists forced."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.inputs import plummer
from benchmark.reference import nbody as reference
from parallelnbody_tpu_torch import SimConfig, api
from parallelnbody_tpu_torch.api import Simulation
from parallelnbody_tpu_torch.kernels.launch import COUNTERS
from parallelnbody_tpu_torch.ops import bh, bh_kernels
from parallelnbody_tpu_torch.state import make_state

torch.set_num_threads(2)

SEED = 2**31 + 419
N = 4096
SMALL = {"bh_near_budget": 4, "bh_far_budget": 4, "bh_cand2_budget": 8,
         "bh_cand_budget": 8}


def _cfg(refine, **kw):
    return SimConfig(n=N, force="barnes_hut", theta=0.72, bh_leaf_size=16,
                     bh_refine=refine, dt=1e-3, softening=0.01,
                     track_potential=False, bh_rebuild_every=8, **kw)


def _state(n=N, seed=SEED):
    pos, vel, mass = plummer.sphere(n, seed)
    return make_state(pos, vel, mass, seed=seed, device="cpu",
                      dtype="float32")


@pytest.fixture(scope="module", params=["dense", "staged"])
def prepared(request):
    """(refine, calibrated cfg, state at t = 0 with its forces)."""
    cal, state = api.prepare_simulation(_cfg(request.param), "cpu",
                                        state=_state())
    return request.param, cal, state


def _call(cfg, k):
    return (api.make_step(cfg, report_overflow=True) if k == 1
            else api.make_run(cfg, k, report_overflow=True))


def _run(cfg, k, state, calls=2):
    """(state after `calls` calls of one step(k) callable, the summed
    overflow, heals, host reads and launches they took)."""
    call = _call(cfg, k)
    before = dict(COUNTERS)
    launches = dict(bh_kernels.LAUNCHES)
    overflow = 0
    for _ in range(calls):
        state, of = call(state)
        overflow += int(of)
    grew = {c: COUNTERS[c] - before[c] for c in ("bh.heals", "host_reads")}
    grew["launches"] = {c: bh_kernels.LAUNCHES[c] - launches[c]
                        for c in launches}
    return state, overflow, grew


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "acc", "time", "step"))


def _plain_overflow(cfg, pos, mass):
    """The clip counter of one evaluation at `pos` without the heal."""
    return int(bh.bh_accel(
        pos, mass, leaf_size=cfg.resolve_bh_leaf_size(), theta=cfg.theta,
        g=cfg.g, softening=cfg.softening,
        near_budget=cfg.resolve_bh_near_budget(),
        far0_budget=cfg.resolve_bh_far_budget(), curve=cfg.bh_curve,
        multipole=cfg.bh_multipole, max_levels=cfg.bh_max_levels,
        compute_pot=False, refine=cfg.resolve_bh_refine(),
        cand_budgets=(cfg.bh_cand2_budget, cfg.bh_cand_budget),
        far_mode=cfg.bh_far_mode, sections=cfg.bh_sections)[2])


@pytest.mark.parametrize("k", [1, 8])
def test_heal_gives_the_full_width_state(prepared, k):
    refine, cal, state = prepared
    auto = sorted(cal.calibrated_budgets)
    assert auto == sorted(SMALL if refine == "staged" else
                          ("bh_near_budget", "bh_far_budget"))
    small = {f: SMALL[f] for f in auto}
    full = cal.replace(bh_near_budget=256, bh_far_budget=4096,
                       bh_cand2_budget=4096, bh_cand_budget=4096)
    want, of_full, _ = _run(full, k, state)
    assert of_full == 0

    # Auto budgets cut to clip at once: healed in the first call, kept for
    # the second (one heal event, each of its rounds a rebuild).
    got, of_cut, grew = _run(cal.calibrated(**small), k, state)
    assert of_cut == 0 and grew["bh.heals"] >= 1
    assert _same(got, want)

    # The same budgets set by the caller: not healed, the overflow of the
    # evaluation without the heal.
    explicit = cal.replace(**small)
    assert not explicit.calibrated_budgets
    got, of_exp, grew = _run(explicit, k, state, calls=1)
    assert grew["bh.heals"] == 0
    at = got.pos if k == 1 else state.pos
    assert of_exp == _plain_overflow(explicit, at, state.mass) > 0

    # A run that never clips: with and without the heal, the same state,
    # heals, host reads and launches.
    with_heal = _run(cal, k, state)
    without = _run(cal.replace(**{f: getattr(cal, f) for f in auto}), k,
                   state)
    assert _same(with_heal[0], without[0])
    assert with_heal[1] == without[1] == 0
    assert with_heal[2] == without[2] and with_heal[2]["bh.heals"] == 0


def _tree(cfg, state):
    pos_s, mass_s, _, tree, _, _ = bh._prepare(
        state.pos, state.mass, leaf_size=cfg.resolve_bh_leaf_size(),
        curve=cfg.bh_curve, multipole_order=cfg.bh_multipole,
        max_levels=cfg.bh_max_levels)
    refine, cands = bh.resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        tree.n_levels, cfg.resolve_bh_near_budget(),
        cfg.resolve_bh_far_budget())
    kw = dict(theta=cfg.theta, near_budget=cfg.resolve_bh_near_budget(),
              far_budget=cfg.resolve_bh_far_budget(), refine=refine,
              cand_budgets=cands, dtype=pos_s.dtype,
              leaf_size=cfg.resolve_bh_leaf_size())
    return tree, kw


def test_lists_without_a_clip_are_the_lists_without_the_heal(prepared):
    _, cal, state = prepared
    tree, kw = _tree(cal, state)
    heal = bh.ListHeal.of(cal)
    plain = bh.bh_plan_lists(tree, **kw)
    healed = bh.bh_plan_lists(tree, heal=heal, **kw)
    assert heal.grown == {}
    for name in ("near_idx", "near_valid", "far_keys", "far_valid",
                 "overflow"):
        assert torch.equal(getattr(plain, name), getattr(healed, name))


def test_staged_heal_repeats_until_nothing_clips():
    """One level-2 candidate a target: the stages after it are
    under-counted while it clips, so the level-1 candidate and near lists
    show what they need only in a second round; the grown budgets clip
    nothing, and the lists hold what lists at full width hold."""
    cal, state = api.prepare_simulation(_cfg("staged"), "cpu",
                                        state=_state())
    cut = cal.calibrated(bh_cand2_budget=1, bh_cand_budget=8,
                         bh_near_budget=4)
    tree, kw = _tree(cut, state)
    heal = bh.ListHeal.of(cut)
    before = COUNTERS["bh.heals"]
    plan = bh.bh_plan_lists(tree, heal=heal, **kw)
    assert int(plan.overflow) == 0
    assert COUNTERS["bh.heals"] - before == 2
    assert set(heal.grown) <= {"near", "far", "cand2", "cand1"}
    # The grown budgets stay: the next build clips nothing and adds no
    # heal.
    again = bh.bh_plan_lists(tree, heal=heal, **kw)
    assert COUNTERS["bh.heals"] - before == 2 and int(again.overflow) == 0
    wide = bh.bh_plan_lists(tree, **{**kw, "near_budget": 256,
                                     "far_budget": 4096,
                                     "cand_budgets": (64, 64)})
    for name in ("near_valid", "far_valid"):
        assert torch.equal(getattr(plan, name).sum(1),
                           getattr(wide, name).sum(1))


def test_heal_falls_back_to_full_width(prepared, monkeypatch):
    """With no rounds by calibration's rule, a clipped budget takes twice
    calibration's budget for its need at once, at most its full width.
    Near and far are cut (their needs are exact in the first round) and
    the lanes made small, so that twice the budget can lie below the full
    width."""
    _, cal, state = prepared
    monkeypatch.setattr(bh, "HEAL_ROUNDS", 0)
    monkeypatch.setattr(bh, "BUDGET_LANES", {k: 8 for k in bh.BUDGET_LANES})
    tree, kw = _tree(cal, state)
    wide = bh.bh_plan_lists(tree, **{**kw, "near_budget": 256,
                                     "far_budget": 4096})
    needs = {"near": int(wide.near_valid.sum(1).max()),
             "far": int(wide.far_valid.sum(1).max())}
    heal = bh.ListHeal.of(cal)
    heal.grown = {"near": 4, "far": 4}
    before = COUNTERS["bh.heals"]
    plan = bh.bh_plan_lists(tree, heal=heal, **kw)
    full = bh._full_widths([c.shape[0] for c in tree.com])
    assert int(plan.overflow) == 0 and COUNTERS["bh.heals"] - before == 1
    for k, need in needs.items():
        assert heal.grown[k] == min(2 * bh.pad_budget(need, 8), full[k])
    assert any(heal.grown[k] < full[k] for k in needs)
    for name in ("near_valid", "far_valid"):
        assert torch.equal(getattr(plan, name).sum(1),
                           getattr(wide, name).sum(1))


def test_calibrated_marks():
    """calibrated() names the budgets it sets; replace() leaves a budget it
    sets to the caller; equality and JSON ignore the marks."""
    cfg = _cfg("dense")
    cal = cfg.calibrated(bh_near_budget=256, bh_far_budget=384)
    assert cal.calibrated_budgets == {"bh_near_budget", "bh_far_budget"}
    assert cal.replace(dt=2e-3).calibrated_budgets == cal.calibrated_budgets
    assert cal.replace(bh_near_budget=512).calibrated_budgets == {
        "bh_far_budget"}
    plain = cfg.replace(bh_near_budget=256, bh_far_budget=384)
    assert plain == cal and not plain.calibrated_budgets
    assert SimConfig.from_json(cal.to_json()) == cal
    assert dataclasses.asdict(cal) == dataclasses.asdict(plain)
    assert bh.ListHeal.of(plain) is None
    assert bh.ListHeal.of(cal).kinds == {"near", "far"}


def test_clip_counter_rides_on_the_item_sizes_read():
    """near_items reads the clip counter in the read of K1's item sizes:
    one host read, the sizes as without it."""
    counts = torch.tensor([0, 5, 40, 33, 1, 64])
    plain = bh_kernels.near_items(counts, 32)
    reads = COUNTERS["host_reads"]
    got = bh_kernels.near_items(counts, 32,
                                overflow=torch.tensor(17, dtype=torch.int64))
    assert COUNTERS["host_reads"] == reads + 1
    assert got.overflow == 17 and plain.overflow is None
    assert torch.equal(got.items, plain.items)
    assert torch.equal(got.splits, plain.splits)
    assert (got.n_partial, got.entries) == (plain.n_partial, plain.entries)


def _rel(got, want):
    num = torch.sqrt(torch.mean(torch.sum((got - want) ** 2, -1)))
    return float(num / torch.sqrt(torch.mean(torch.sum(want ** 2, -1))))


# Barnes-Hut's accuracy class at theta 0.72 with quadrupoles: relative rms
# about 1e-3 of the force (0.85-1.03e-3 measured at this size), so 2e-3;
# without the quadrupole term 3.5-4.1e-3, above it. The displacement over
# 8 steps of 1e-4 is ~1e-4 of positions of order 1: float32 rounding of
# the positions alone is ~5e-4 of it.
ACC_TOL = 2e-3
DX_TOL = 2e-3


def test_configuration_shape_against_the_plain_reference():
    """The cell's configuration (theta 0.72, quadrupoles, staged lists,
    rebuild 8, step(8) through Simulation) at N = 16384, leaf 64, against
    benchmark/reference/nbody.py's float64 direct sums at 1024 targets: the
    acceleration at the start and after 8 steps, the 8-step displacement
    and velocity change."""
    n = 16384
    cfg = SimConfig(n=n, force="barnes_hut", theta=0.72, bh_multipole=2,
                    bh_leaf_size=64, bh_refine="staged", bh_rebuild_every=8,
                    dt=1e-4, softening=0.01, track_potential=False)
    sim = Simulation(cfg, "cpu", state=_state(n))
    start = sim.state
    end = sim.step(8)
    assert int(sim.overflow) == 0 and int(end.step) == 8
    targets = torch.as_tensor(np.sort(np.random.default_rng(SEED).choice(
        n, 1024, replace=False)))
    f64 = lambda t: t.to(torch.float64)  # noqa: E731
    a0, x, v, a = reference.leapfrog_at(
        f64(start.pos), f64(start.vel), f64(start.mass), targets, steps=8,
        dt=cfg.dt, g=cfg.g, softening=cfg.softening)
    x0, v0 = f64(start.pos)[targets], f64(start.vel)[targets]
    assert _rel(f64(start.acc)[targets], a0) < ACC_TOL
    assert _rel(f64(end.acc)[targets], a) < ACC_TOL
    assert _rel(f64(end.pos)[targets] - x0, x - x0) < DX_TOL
    assert _rel(f64(end.vel)[targets] - v0, v - v0) < ACC_TOL
    # Without the quadrupole term the same check fails.
    mono = bh.bh_accel(start.pos, start.mass, leaf_size=64, theta=0.72,
                       g=cfg.g, softening=cfg.softening,
                       near_budget=sim.cfg.bh_near_budget,
                       far0_budget=sim.cfg.bh_far_budget, multipole=1,
                       compute_pot=False, refine="staged",
                       cand_budgets=(sim.cfg.bh_cand2_budget,
                                     sim.cfg.bh_cand_budget))
    assert int(mono[2]) == 0
    assert _rel(f64(mono[0])[targets], a0) > ACC_TOL


def test_simulation_shares_one_heal_with_its_diagnostics(prepared):
    """Simulation's step(1), step(8) and diagnostics() share one heal: the
    budgets that diagnostics() grew are not healed again by the steps, and
    its potential is the one full-width lists give, not that of the
    clipped lists."""
    _, cal, state = prepared
    small = {f: 4 for f in cal.calibrated_budgets}
    full = cal.replace(bh_near_budget=256, bh_far_budget=4096,
                       bh_cand2_budget=4096, bh_cand_budget=4096)
    want = Simulation(full, "cpu", state=state).diagnostics()
    clipped = Simulation(cal.replace(**small), "cpu",
                         state=state).diagnostics()
    assert clipped["potential"] != want["potential"]

    sim = Simulation(cal.calibrated(**small), "cpu", state=state)
    before = COUNTERS["bh.heals"]
    got = sim.diagnostics()
    assert (got["potential"], got["energy"]) == (want["potential"],
                                                 want["energy"])
    healed = COUNTERS["bh.heals"] - before
    assert healed >= 1
    sim.step(1)
    sim.step(8)
    assert COUNTERS["bh.heals"] - before == healed
    assert int(sim.overflow) == 0


@pytest.mark.parametrize("k", [1, 8])
def test_heal_span_and_counter(prepared, k):
    """Each rebuild after a clip is a `bh.heal` span holding the rebuilt
    lists, one `bh.heals` count each; none where nothing clips."""
    from parallelnbody_tpu_torch.utils import profiling

    _, cal, state = prepared
    cut = cal.calibrated(**{f: 4 for f in cal.calibrated_budgets})
    for cfg, heals in ((cut, True), (cal, False)):
        call = _call(cfg, k)
        profiling.take_spans()
        before = COUNTERS["bh.heals"]
        with profiling.tracing(True):
            call(state)
        spans = profiling.take_spans()
        grew = COUNTERS["bh.heals"] - before
        by_id = {s.id: s for s in spans}
        heal = [s for s in spans if s.name == "bh.heal"]
        assert len(heal) == grew and (grew > 0) == heals
        for s in heal:
            assert by_id[s.parent].name == ("force" if k == 1
                                            else "api.block")
        rebuilt = [s for s in spans if s.name == "bh.lists"
                   and s.parent in by_id
                   and by_id[s.parent].name == "bh.heal"]
        assert len(rebuilt) == len(heal)
        # One window: a rebuild reuses the traversal it already made.
        assert not [s for s in spans if s.name == "bh.traverse"
                    and by_id[s.parent].name == "bh.heal"]
