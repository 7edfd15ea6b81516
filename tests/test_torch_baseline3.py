"""BASELINE config 3 on the CPU: Barnes-Hut with Morton-sorted leaves,
theta 0.5, quadrupoles and the potential in the hot step, through the
entry `Simulation.step(8)` takes (`api.prepare_simulation`, then
`api.make_run(cfg, 8)`, one rebuild block of 8 frozen-list evaluations).

A Plummer sphere of the benchmark's sampler, N = 4000 at leaf 16: 250
leaves padded to 256 (96 zero-mass pad rows), staged lists over four
levels, the plain versions of K1 and K2. The port is held

  * to the float64 direct sums of benchmark/reference/ (accelerations and
    potentials at 1024 seeded targets, at t = 0 and after the block), at
    tolerances set by the Barnes-Hut error of theta 0.5 with quadrupoles,
    which theta 0.72 and the monopole exceed;
  * to the JAX package on the integer outputs: Morton keys, the sort
    orders of bh_accel's preparation and of the rebuild block's re-sort,
    the staged near and far lists and their overflow counts;
  * to itself: the potential a step(8) call returns is the one its last
    frozen-list evaluation gives at the call's last positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.check import rel_rms
from benchmark.inputs import plummer
from benchmark.reference import nbody as reference
from benchmark.reference import potential as reference_pot
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.ops.morton import morton_encode as j_morton
from parallelnbody_tpu_torch import SimConfig, api
from parallelnbody_tpu_torch.kernels.launch import COUNTERS
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.ops.morton import morton_encode as t_morton
from parallelnbody_tpu_torch.state import make_state

torch.set_num_threads(2)

SEED = 2**31 + 2323
N, LEAF, TARGETS = 4000, 16, 1024
CFG = SimConfig(n=N, force="barnes_hut", theta=0.5, bh_curve="morton",
                bh_multipole=2, track_potential=True, bh_leaf_size=LEAF,
                bh_refine="staged", dt=1e-4, softening=0.01,
                bh_rebuild_every=8)
# Relative rms against the float64 direct sums. The port reads 3.15e-4
# (acc) and 3.0e-5 (pot) on this sphere, at t = 0 and after the block
# alike: the Barnes-Hut error of theta 0.5 with quadrupoles, which float32
# rounding (~1e-6) does not move. theta 0.72 reads 1.8e-3 / 1.1e-4 and the
# monopole 1.9e-3 / 4.9e-4 (test_looser_settings_fail_the_tolerances).
ACC_TOL = 6e-4
POT_TOL = 6e-5


def _state(n=N, seed=SEED):
    pos, vel, mass = plummer.sphere(n, seed)
    return make_state(pos, vel, mass, seed=seed, device="cpu",
                      dtype="float32")


def _targets():
    rng = np.random.default_rng([SEED, 1])
    return torch.as_tensor(np.sort(rng.choice(N, TARGETS, replace=False)))


def _errors(state):
    """(acc, pot) relative rms of state at the targets against the float64
    direct sums at its positions. The port's potential holds each body's
    softened self-term -g m_i / eps (ops/energy.py), as the reference's
    does when the targets' own rows are kept."""
    idx = _targets()
    pos = state.pos.to(torch.float64)
    mass = state.mass.to(torch.float64)
    kw = dict(g=CFG.g, softening=CFG.softening)
    acc = reference.accel_at(pos[idx], pos, mass, self_index=idx, **kw)
    pot = reference_pot.potential_at(pos[idx], pos, mass, **kw)
    return (rel_rms(state.acc[idx].to(torch.float64), acc),
            rel_rms(state.pot[idx, None].to(torch.float64), pot[:, None]))


@pytest.fixture(scope="module")
def prepared():
    """(calibrated cfg, state at t = 0 with its forces)."""
    return api.prepare_simulation(CFG, "cpu", state=_state())


@pytest.fixture(scope="module")
def block(prepared):
    """(state after one step(8) call, its overflow, the bh.pot_evals the
    call counted)."""
    cal, state = prepared
    before = COUNTERS["bh.pot_evals"]
    out, overflow = api.make_run(cal, 8, report_overflow=True)(state)
    return out, overflow, COUNTERS["bh.pot_evals"] - before


def test_config_takes_the_staged_rebuild_path(prepared):
    cal, state = prepared
    setup = bh.BHSetup.of(cal)
    assert (setup.refine, setup.far_mode, setup.sections) == \
        ("staged", "octet", 1)
    assert (setup.n_leaves, setup.n_pad, setup.n_levels) == (256, 4096, 4)
    assert setup.curve == "morton" and setup.compute_pot
    assert api._reuse_eligible(cal, 8, "cpu")
    assert api._reuse_block_size(cal.bh_rebuild_every, 8) == 8
    assert cal.calibrated_budgets == frozenset(bh.BUDGET_FIELDS.values())
    assert bool(torch.any(state.pot != 0))


@pytest.mark.parametrize("when", ["t0", "after_block"])
def test_forces_against_the_direct_sums(prepared, block, when):
    """acc and pot at the targets within the tolerances, at t = 0 and
    after the block; nothing clipped, all 8 steps taken."""
    out, overflow, _ = block
    state = prepared[1] if when == "t0" else out
    acc_err, pot_err = _errors(state)
    assert acc_err < ACC_TOL, acc_err
    assert pot_err < POT_TOL, pot_err
    assert int(overflow) == 0 and int(out.step) == 8


@pytest.mark.parametrize("change", [{"theta": 0.72}, {"bh_multipole": 1}],
                         ids=["theta0.72", "monopole"])
def test_looser_settings_fail_the_tolerances(change):
    """The tolerances resolve the setting: theta 0.72, or the monopole at
    theta 0.5, exceeds both at t = 0 on the same sphere."""
    _, state = api.prepare_simulation(CFG.replace(**change), "cpu",
                                      state=_state())
    acc_err, pot_err = _errors(state)
    assert acc_err > ACC_TOL, acc_err
    assert pot_err > POT_TOL, pot_err


def test_keys_and_sort_orders_equal_jax(prepared):
    """Morton keys and bh_accel's sort (pads keyed last), and the rebuild
    block's re-sort of the rows as the run carries them (pads at the
    origin, left out of the domain cube by their original index), against
    the JAX package's on the same float32 rows."""
    _, state = prepared
    pos, mass = state.pos, state.mass
    p, m = jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy())
    jps, _, jperm, _, _, n_pad = jbh._prepare(p, m, leaf_size=LEAF,
                                              curve="morton")
    tps, _, tperm, _, _, t_pad = bh._prepare(pos, mass, leaf_size=LEAF,
                                             curve="morton")
    assert t_pad == n_pad == 4096
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))

    # The re-sort of _make_run_reuse's carry (JAX api.py sort_block).
    rows = torch.cat([pos, pos.new_zeros((n_pad - N, 3))])
    orig = torch.arange(n_pad, dtype=torch.int32)
    live = orig < N
    perm, _ = bh._curve_order(rows, "morton", live=live)
    jr, jlive = jnp.asarray(rows.numpy()), jnp.asarray(live.numpy())
    lo = jnp.min(jnp.where(jlive[:, None], jr, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(jlive[:, None], jr, -jnp.inf), axis=0)
    center, half, _ = jbh.domain_cube(lo, hi)
    jkeys = jnp.where(jlive, j_morton(jr, center, half),
                      jnp.iinfo(jnp.int32).max)
    _, jorder = jax.lax.sort((jkeys, jnp.arange(n_pad, dtype=jnp.int32)),
                             num_keys=2)
    tc, th, _ = bh._cube_of(rows, live)
    np.testing.assert_array_equal(
        torch.where(live, t_morton(rows, tc, th), bh.INT32_MAX).numpy(),
        np.asarray(jkeys))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jorder))
    assert bool((perm[:N] < N).all())


@pytest.mark.parametrize("budgets", ["calibrated", "clipping"])
def test_lists_equal_jax(prepared, budgets):
    """The staged octet lists of the rebuild block (bh_plan_lists) at theta
    0.5 on the JAX package's Morton tree, handed over so that no MAC
    decision can flip on the pyramid's rounding: near and far lists and
    the overflow count equal, at the calibrated budgets (nothing clipped)
    and at budgets that clip every stage."""
    cal, state = prepared
    p = jnp.asarray(state.pos.numpy())
    m = jnp.asarray(state.mass.numpy())
    jt = jbh._prepare(p, m, leaf_size=LEAF, curve="morton",
                      multipole_order=2)[3]
    tt = bh.BHTree(*(tuple(None if x is None else
                           torch.from_numpy(np.array(x)) for x in
                           getattr(jt, f))
                     for f in ("com", "mass", "radius", "quad")))
    if budgets == "calibrated":
        near, far = cal.bh_near_budget, cal.bh_far_budget
        cands = (cal.bh_cand2_budget, cal.bh_cand_budget)
    else:
        near, far, cands = 24, 40, (6, 20)
    kw = dict(theta=0.5, near_budget=near, far_budget=far, refine="staged",
              cand_budgets=cands)
    jplan = jbh.bh_plan_lists(jt, dtype=jnp.float32, **kw)
    tplan = bh.bh_plan_lists(tt, dtype=torch.float32, leaf_size=LEAF, **kw)
    for name in ("near_idx", "near_valid", "far_keys", "far_valid",
                 "overflow"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    assert (int(tplan.overflow) == 0) == (budgets == "calibrated")


def test_step8_potential_is_the_last_frozen_list_evaluation(prepared,
                                                            block):
    """The block's lists rebuilt from the call's input rows and evaluated
    at its last positions give the acc and pot the call returned, bit for
    bit: no frozen-list evaluation drops the potential, and the exit
    unsort carries it."""
    cal, state = prepared
    out, _, _ = block
    setup = bh.BHSetup.of(cal)
    n_pad = setup.n_pad
    z3 = state.pos.new_zeros((n_pad - N, 3))
    rows, _, accel_fn = bh.rebuild_block(
        torch.cat([state.pos, z3]), torch.cat([state.vel, z3]),
        torch.cat([state.acc, z3]),
        torch.cat([state.mass, state.mass.new_zeros(n_pad - N)]),
        torch.arange(n_pad, dtype=torch.int32), setup, N,
        api._list_heal(cal))
    orig_s = rows[4].long()
    acc, pot = accel_fn(torch.cat([out.pos, z3])[orig_s])
    back = torch.empty_like(orig_s)
    back[orig_s] = torch.arange(n_pad)
    assert torch.equal(pot[back[:N]], out.pot)
    assert torch.equal(acc[back[:N]], out.acc)
    assert bool(torch.all(out.pot < 0))


def test_pot_evals_count_the_potential_evaluations(prepared, block):
    """bh.pot_evals: 8 a step(8) call with the potential on, 0 with it
    off (a smaller sphere, dense lists)."""
    assert block[2] == 8
    cfg = CFG.replace(n=1024, bh_refine="dense", track_potential=False)
    cal, state = api.prepare_simulation(cfg, "cpu", state=_state(1024))
    before = COUNTERS["bh.pot_evals"]
    out = api.make_run(cal, 8)(state)
    assert COUNTERS["bh.pot_evals"] == before
    assert int(out.step) == 8 and not bool(out.pot.any())


@pytest.mark.parametrize("dropped", ["near_field", "far_octet"])
def test_pot_evals_read_the_calls_not_the_setting(prepared, monkeypatch,
                                                  dropped):
    """bh.pot_evals counts what K1 and K2 were asked for: with the
    potential on in the configuration but dropped from one of the two
    calls, a step(8) call counts no evaluation, and the wrappers' counts
    (bh_kernels.POT_CALLS) show which call lost it."""
    from parallelnbody_tpu_torch.ops import bh_kernels

    cal, state = prepared
    wrapped = getattr(bh_kernels, dropped)

    def without_pot(*args, **kw):
        return wrapped(*args, **{**kw, "compute_pot": False})

    monkeypatch.setattr(bh_kernels, dropped, without_pot)
    before = COUNTERS["bh.pot_evals"]
    calls = dict(bh_kernels.POT_CALLS)
    api.make_run(cal, 8)(state)
    assert COUNTERS["bh.pot_evals"] == before
    grew = {k: bh_kernels.POT_CALLS[k] - v for k, v in calls.items()}
    kept = "far" if dropped == "near_field" else "near"
    assert grew == {kept: 8, ("near" if kept == "far" else "far"): 0}
