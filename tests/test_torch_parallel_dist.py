"""The port's distributed Barnes-Hut (parallelnbody_tpu_torch.parallel.
distributed) on CPU ranks held against the JAX package's on its 8 virtual
CPU devices, on the same inputs, one force evaluation at a time:

  * integer outputs, rank by rank: the repartition's ownership (id_own,
    valid_own), migrant and exchange-overflow counts, the near and far
    lists of each rank's target leaves and their overflow, the LET plan's
    remapped lists and import overflow; at 1, 2, 3, 5, 7 and 8 ranks,
    dense and staged, octet and gather, an adversarial pre-partitioned
    state (exchange overflow), a starved import budget (LET clip) and
    small shards with large leaves;
  * forces of dist_bh_accel (ring and LET): rtol 1e-9 in f64, and the
    accuracy rules of tests/test_parallel.py;
  * calibrate_budgets(n_ranks=8) and measure_import_requirement.

The ranks are spawned processes (parallel/mesh.RankPool), kept across the
cases of one rank count, each case with its own deadline.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from parallelnbody_tpu.api import init_simulation
from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.ops import bh as JB
from parallelnbody_tpu.parallel import distributed as JD
from parallelnbody_tpu.parallel import make_ring_mesh, shard_state
from parallelnbody_tpu.parallel.sharded import sharded_bh_overflow
from parallelnbody_tpu_torch import SimConfig as TorchConfig
from parallelnbody_tpu_torch.parallel import RankPool, tasks

torch.set_num_threads(2)

DEADLINE = 90.0
_POOL = {}


@pytest.fixture(scope="module", autouse=True)
def _close_pool():
    yield
    for pool in _POOL.values():
        pool.close()
    _POOL.clear()


def ranks(n):
    if n not in _POOL or _POOL[n].closed:
        for pool in _POOL.values():
            pool.close()
        _POOL.clear()
        _POOL[n] = RankPool(n, "cpu", timeout=DEADLINE)
    return _POOL[n]


def _dist_cfg(n, **kw):
    return SimConfig(n=n, ic="plummer", dt=1e-3, softening=0.02,
                     force="barnes_hut", bh_leaf_size=32, bh_near_budget=256,
                     dtype="float64", bh_distributed=True,
                     bh_rebuild_every=1).replace(**kw)


def arrays(state):
    return {k: np.asarray(getattr(state, k))
            for k in ("pos", "vel", "mass", "acc", "pot", "time", "step")}


def tjson(cfg):
    return TorchConfig(**dataclasses.asdict(cfg)).to_json()


def jax_geometry(cfg, state, n_dev):
    """The JAX package's integer outputs of one distributed evaluation,
    per rank (its own functions, inside shard_map)."""
    mesh = make_ring_mesh(n_dev)
    leaf = cfg.resolve_bh_leaf_size()

    def local(pos, mass):
        axis = "ring"
        n_ranks, rank = lax.axis_size(axis), lax.axis_index(axis)
        n_local = pos.shape[0]
        cap_pair, own_cap, n_leaf_loc = JD._plan_cfg(cfg, n_local, n_ranks,
                                                     leaf)
        ids = rank * n_local + jnp.arange(n_local, dtype=jnp.int32)
        (pos_own, _, mass_own, id_own, valid_own, sentinel, of_ex,
         mig) = JD._repartition(
            pos, [], mass, ids, jnp.ones((n_local,), bool), rank=rank,
            n_ranks=n_ranks, cap_pair=cap_pair, own_cap=own_cap,
            n_live=n_local, curve=cfg.bh_curve, axis=axis)
        tree = JD._owned_tree(pos_own, mass_own, sentinel, cfg,
                              leaf_size=leaf, axis=axis)
        refine, cands = JB.resolve_refine(
            cfg.resolve_bh_refine(), (cfg.bh_cand2_budget,
                                      cfg.bh_cand_budget),
            tree.n_levels, cfg.resolve_bh_near_budget(),
            cfg.resolve_bh_far_budget())
        far_mode = JB.resolve_far_mode(cfg.bh_far_mode, refine)
        start = rank * n_leaf_loc
        kw = dict(theta=cfg.theta, start_leaf=start, n_slice=n_leaf_loc,
                  near_budget=cfg.resolve_bh_near_budget(), dtype=pos.dtype)
        if refine == "staged":
            fm, rej = JB.traverse(tree, cfg.theta, start_leaf=start,
                                  n_slice=n_leaf_loc, stop_level=2)
            ni, nv, fi, fv, _, of = JB.build_interaction_lists_staged(
                tree, fm, rej, far_budget=cfg.resolve_bh_far_budget(),
                cand2_budget=cands[0], cand1_budget=cands[1],
                octet_far=far_mode == "octet", **kw)
        elif far_mode == "octet":
            fm, rej = JB.traverse(tree, cfg.theta, start_leaf=start,
                                  n_slice=n_leaf_loc)
            ni, nv, fi, fv, _, of = JB.build_interaction_lists_octet(
                tree, fm, rej, far_budget=cfg.resolve_bh_far_budget(), **kw)
        else:
            fm, rej = JB.traverse(tree, cfg.theta, start_leaf=start,
                                  n_slice=n_leaf_loc)
            ni, nv, fi, fv, *_, of = JB.build_interaction_lists(
                tree, fm, rej, far0_budget=cfg.resolve_bh_far_budget(),
                **kw)
        lp = JD._near_let_plan(ni, nv, cfg, rank=rank, n_ranks=n_ranks,
                               n_leaf_loc=n_leaf_loc, axis=axis)
        return (id_own, valid_own, mig[None], of_ex[None], ni, nv, fi, fv,
                jnp.asarray(of, jnp.int32)[None], lp.new_idx,
                lp.overflow[None])

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("ring"), P("ring")),
                       out_specs=(P("ring"),) * 11, check_vma=False)
    out = [np.asarray(x) for x in jax.jit(fn)(state.pos, state.mass)]
    names = ("id_own", "valid_own", "migrants", "of_exchange", "near_idx",
             "near_valid", "far_idx", "far_valid", "of_lists", "let_new_idx",
             "let_overflow")
    return [{k: np.split(v, n_dev)[r] for k, v in zip(names, out)}
            for r in range(n_dev)]


def adversarial(state):
    """Particles ordered by descending x before sharding: each rank holds a
    slab of key space that other ranks own (tests/test_parallel.py:276)."""
    order = jnp.argsort(-state.pos[:, 0])
    return state._replace(pos=state.pos[order], vel=state.vel[order],
                          mass=state.mass[order], acc=state.acc[order],
                          pot=state.pot[order])


GEOMETRY = {
    "p1_dense": (1, dict()),
    "p2_dense": (2, dict()),
    "p3_staged": (3, dict(bh_refine="staged")),
    "p5_gather": (5, dict(bh_far_mode="gather")),
    "p7_small_shards_large_leaves": (7, dict(bh_leaf_size=512,
                                             bh_near_budget=16)),
    "p8_dense": (8, dict()),
    "p8_staged_let_budget1": (8, dict(bh_refine="staged", bh_comm="let",
                                      bh_import_budget=1)),
    "p8_adversarial": (8, dict()),
}


def _tree_widths(cfg, n_dev):
    """Level widths of the distributed tree (build_upper's rule: shrink by
    8 where divisible, else collapse into one node)."""
    n_local = cfg.n // n_dev
    widths = [n_dev * JD._plan_cfg(cfg, n_local, n_dev,
                                   cfg.resolve_bh_leaf_size())[2]]
    while widths[-1] > 1 and len(widths) < cfg.bh_max_levels:
        w = widths[-1]
        widths.append(w // 8 if w % 8 == 0 else 1)
    return widths


def _staged_parent_over_8(cfg, n_dev):
    """Whether the tree is refined in stages and one of the two levels the
    stages refine has a parent of more than 8 children: there the JAX
    package's octet keys carry past their octet
    (tests/test_torch_octet_children.py), and the port's differ."""
    widths = _tree_widths(cfg, n_dev)
    refine, _ = JB.resolve_refine(cfg.resolve_bh_refine(), (1, 1),
                                  len(widths), 1, 1)
    return refine == "staged" and any(widths[k - 1] // widths[k] > 8
                                      for k in (1, 2))


def _far_nodes(widths, idx, valid, octet):
    """Each target row's far list as sorted (level, node) pairs: octet keys
    over the 8-aligned table, or node ids over the stacked table."""
    from parallelnbody_tpu_torch.ops import bh as tbh

    offs = (tbh._octet_offsets(widths)[0] if octet
            else tbh._level_offsets(widths))
    rows = []
    for ir, vr in zip(np.asarray(idx), np.asarray(valid)):
        nodes = []
        for e in (int(x) for x in ir[vr]):
            base = e >> 8 if octet else e
            k = max(i for i, o in enumerate(offs) if o <= base)
            nodes += ([(k, (base - offs[k]) * 8 + b) for b in range(8)
                       if e >> b & 1] if octet else [(k, e - offs[k])])
        rows.append(sorted(nodes))
    return rows


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_owned_geometry_equals_jax(eight_devices, case):
    """Every integer output equal to the JAX package's, rank by rank. Where
    a staged parent has more than 8 children (p8_staged_let_budget1: levels
    80 / 10 / 1), the octet far list alone is held instead to the gather
    form of the same lists (octet_far=False, right for any branch factor),
    which equals the JAX package's gather form bit for bit: the octet keys
    name exactly the gather list's nodes."""
    n_dev, kw = GEOMETRY[case]
    cfg = _dist_cfg(256 * n_dev if n_dev > 1 else 1024, **kw)
    state = init_simulation(cfg.replace(force="direct"))
    if case == "p8_adversarial":
        state = adversarial(state)
    want = jax_geometry(cfg, state, n_dev)
    got = ranks(n_dev).run(tasks.owned_geometry, tjson(cfg), arrays(state))
    wide = _staged_parent_over_8(cfg, n_dev)
    assert wide == (case == "p8_staged_let_budget1")
    for r in range(n_dev):
        for k, v in want[r].items():
            if wide and k in ("far_idx", "far_valid"):
                continue
            np.testing.assert_array_equal(np.asarray(got[r][k]).reshape(
                v.shape), v, err_msg=f"{case} rank {r} {k}")
    if wide:
        gcfg = cfg.replace(bh_far_mode="gather")
        want_g = jax_geometry(gcfg, state, n_dev)
        got_g = ranks(n_dev).run(tasks.owned_geometry, tjson(gcfg),
                                 arrays(state))
        widths = _tree_widths(cfg, n_dev)
        for r in range(n_dev):
            for k, v in want_g[r].items():
                np.testing.assert_array_equal(
                    np.asarray(got_g[r][k]).reshape(v.shape), v,
                    err_msg=f"{case} gather rank {r} {k}")
            assert _far_nodes(widths, got[r]["far_idx"], got[r]["far_valid"],
                              True) == _far_nodes(
                widths, got_g[r]["far_idx"], got_g[r]["far_valid"], False)
    if case == "p8_adversarial":
        assert sum(int(w["of_exchange"][0]) for w in want) > 0
    if case == "p8_staged_let_budget1":
        assert sum(int(w["let_overflow"][0]) for w in want) > 0


def _dist_accel(cfg, state, n_dev):
    outs = ranks(n_dev).run(tasks.sharded, tjson(cfg), arrays(state),
                            "dist_accel")
    acc = np.concatenate([o["state"]["acc"] for o in outs])
    pot = np.concatenate([o["state"]["pot"] for o in outs])
    return acc, pot, outs[0]["overflow"]


def _jax_dist_accel(cfg, state, n_dev):
    mesh = make_ring_mesh(n_dev)
    fn = jax.shard_map(lambda p, m: JD.dist_bh_accel(p, m, cfg, "ring"),
                       mesh=mesh, in_specs=(P("ring"), P("ring")),
                       out_specs=(P("ring"), P("ring"), P()),
                       check_vma=False)
    acc, pot, of = jax.jit(fn)(state.pos, state.mass)
    return np.asarray(acc), np.asarray(pot), int(of)


def _rms(a, ref):
    den = np.sqrt(np.mean(np.sum(np.asarray(ref) ** 2, 1)))
    return np.sqrt(np.mean(np.sum((a - np.asarray(ref)) ** 2, 1))) / den


@pytest.mark.parametrize("n_dev,kw", [
    (3, dict()), (4, dict(bh_comm="let")), (8, dict()),
    (8, dict(bh_comm="let")), (8, dict(bh_refine="staged")),
    (8, dict(bh_refine="staged", bh_comm="let"))],
    ids=["p3_ring", "p4_let", "p8_ring", "p8_let", "p8_staged_ring",
         "p8_staged_let"])
def test_dist_accel_equals_jax(eight_devices, n_dev, kw):
    """dist_bh_accel's forces equal the JAX package's (rtol 1e-9, f64) and
    stay in the single-device accuracy class against the direct sum;
    overflow 0 as in the JAX package."""
    from parallelnbody_tpu.api import make_accel_fn

    cfg = _dist_cfg(256 * n_dev, **kw)
    state = init_simulation(cfg.replace(force="direct"))
    acc, pot, of = _dist_accel(cfg, state, n_dev)
    jacc, jpot, jof = _jax_dist_accel(cfg, state, n_dev)
    np.testing.assert_allclose(acc, jacc, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(pot, jpot, rtol=1e-9, atol=1e-12)
    assert of == jof == 0
    # state.acc is the direct sum; ref the single-device Barnes-Hut.
    ref, _ = make_accel_fn(cfg.replace(bh_distributed=False),
                           state.mass)(state.pos)
    assert _rms(acc, state.acc) < 1.5 * _rms(np.asarray(ref),
                                              state.acc) + 1e-3
    assert _rms(acc, ref) < 2e-3


def test_let_matches_ring_and_clip_is_counted(eight_devices):
    """LET against the ring near field to summation-order noise; a starved
    import budget counts its clipped imports (the JAX package's count) and
    keeps the forces finite; a generous pair slack cures the adversarial
    exchange overflow, as in the JAX package."""
    cfg = _dist_cfg(2048)
    state = init_simulation(cfg.replace(force="direct"))
    ring, _, _ = _dist_accel(cfg, state, 8)
    let, _, of = _dist_accel(cfg.replace(bh_comm="let"), state, 8)
    assert of == 0 and _rms(let, ring) < 1e-6
    starved = cfg.replace(bh_comm="let", bh_import_budget=1)
    acc, _, of = _dist_accel(starved, state, 8)
    mesh = make_ring_mesh(8)
    assert of == sharded_bh_overflow(starved, mesh,
                                     shard_state(state, mesh)) > 0
    assert np.all(np.isfinite(acc))
    adv = adversarial(state)
    _, _, of = _dist_accel(cfg, adv, 8)
    assert of == sharded_bh_overflow(cfg, mesh, shard_state(adv, mesh)) > 0
    _, _, of = _dist_accel(cfg.replace(bh_pair_slack=16.0), adv, 8)
    assert of == 0


def test_import_budget_calibration_equals_jax(eight_devices):
    """calibrate_budgets(n_ranks=8) picks the JAX package's budgets
    (bh_import_budget included); the calibrated LET run equals the
    full-width one bit for bit with zero overflow."""
    from parallelnbody_tpu.api import calibrate_budgets as jcal
    from parallelnbody_tpu_torch.api import calibrate_budgets
    from parallelnbody_tpu_torch.state import state_from_numpy

    cfg = _dist_cfg(2048, bh_comm="let")
    state = init_simulation(cfg)
    want = jcal(cfg, state, n_ranks=8)
    tcfg = TorchConfig(**dataclasses.asdict(cfg))
    got = calibrate_budgets(tcfg, state_from_numpy(arrays(state), "cpu",
                                                   torch.float64), n_ranks=8)
    assert got.bh_import_budget == want.bh_import_budget > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full, _, _ = _dist_accel(cfg, state, 8)
    cal, _, of = _dist_accel(cfg.replace(
        bh_import_budget=got.bh_import_budget), state, 8)
    assert of == 0
    np.testing.assert_array_equal(cal, full)


def test_measure_import_requirement_equals_jax():
    """Two separated clusters on 2 ranks: the same requirement as the JAX
    package's, a small share of the full neighbour width."""
    from parallelnbody_tpu_torch.ops.bh import measure_import_requirement

    rng = np.random.default_rng(0)
    a = rng.normal(size=(1024, 3)) * 0.5
    b = rng.normal(size=(1024, 3)) * 0.5 + np.array([100.0, 0.0, 0.0])
    pos = np.concatenate([a, b])
    mass = np.ones((2048,))
    cfg = SimConfig(n=2048, force="barnes_hut", bh_leaf_size=32, theta=0.72,
                    dtype="float64")
    want = JB.measure_import_requirement(jnp.asarray(pos), jnp.asarray(mass),
                                         cfg, 2)
    got = measure_import_requirement(
        torch.from_numpy(pos), torch.from_numpy(mass),
        TorchConfig(**dataclasses.asdict(cfg)), 2)
    assert got == want
    assert got["import_max"] < got["n_leaf_loc_proxy"] // 2
