"""The port's persistent distributed run (parallel/distributed.py
make_distributed_run: key-sharded carry, the rebuild-interval blocks, the
LET plan once a block) and the sharded runs over it, on CPU ranks, held
against the JAX package's make_distributed_run on its 8 virtual CPU devices
from the same state: positions and velocities to rtol 1e-9 in f64 (the same
operations in the same order), overflow and migrant counts equal. Also the
100-step drift gate of the rebuild interval against the port's C++ oracle,
and __graft_entry__'s distributed paths (3 to 5) at 5 ranks.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.api import init_simulation
from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.parallel import make_ring_mesh, shard_state
from parallelnbody_tpu.parallel.distributed import (_dist_reuse_eligible,
                                                    make_distributed_run)
from parallelnbody_tpu.parallel.sharded import (make_sharded_run,
                                                sharded_init_accel)
from parallelnbody_tpu_torch import SimConfig as TorchConfig
from parallelnbody_tpu_torch.parallel import RankPool, tasks
from parallelnbody_tpu_torch.parallel.distributed import \
    _dist_reuse_eligible as t_eligible

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


def tcfg(cfg):
    return TorchConfig(**dataclasses.asdict(cfg))


def arrays(state):
    return {k: np.asarray(getattr(state, k))
            for k in ("pos", "vel", "mass", "acc", "pot", "time", "step")}


def start_state(cfg, n_dev):
    """The JAX package's sharded state after sharded_init_accel: the start
    of both packages' runs."""
    mesh = make_ring_mesh(n_dev)
    state = shard_state(init_simulation(cfg, compute_forces=False), mesh)
    return mesh, sharded_init_accel(cfg, mesh, state)


def port(n_dev, cfg, state, program, n_steps, debug_exchange=False):
    outs = ranks(n_dev).run(tasks.sharded, tcfg(cfg).to_json(),
                            arrays(state), program, n_steps, debug_exchange)
    whole = {k: np.concatenate([o["state"][k] for o in outs])
             for k in ("pos", "vel", "mass", "acc", "pot")}
    whole.update(step=int(outs[0]["state"]["step"]),
                 time=float(outs[0]["state"]["time"]))
    return whole, outs[0]


def close(a, b, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


RUNS = {
    "p8_ring_5": (8, dict(), 5),
    "p8_rk4_no_pot_3": (8, dict(track_potential=False, integrator="rk4"), 3),
    "p8_small_shards_large_leaves_3": (8, dict(bh_leaf_size=512,
                                               bh_near_budget=16), 3),
    "p8_rebuild2_ring_5": (8, dict(bh_rebuild_every=2), 5),
    "p8_rebuild2_let_4": (8, dict(bh_comm="let", bh_rebuild_every=2), 4),
    "p4_let_5": (4, dict(bh_comm="let"), 5),
    "p2_rebuild2_staged_3": (2, dict(bh_rebuild_every=2,
                                     bh_refine="staged"), 3),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_distributed_run_equals_jax(eight_devices, case):
    n_dev, kw, n_steps = RUNS[case]
    cfg = _dist_cfg(256 * n_dev if n_dev > 2 else 1024, **kw)
    mesh, state = start_state(cfg, n_dev)
    ref, of_ref = make_distributed_run(cfg, mesh, n_steps)(state)
    got, out = port(n_dev, cfg, state, "distributed", n_steps)
    assert out["overflow"] == int(of_ref) == 0
    assert got["step"] == int(ref.step) == n_steps
    assert got["time"] == pytest.approx(float(ref.time))
    close(got["pos"], ref.pos)
    close(got["vel"], ref.vel)
    close(got["acc"], ref.acc, 1e-8, 1e-11)
    np.testing.assert_array_equal(got["mass"], np.asarray(ref.mass))
    if "small_shards" in case:
        # No particle teleports to a sentinel (tests/test_parallel.py:349).
        r0 = float(jnp.max(jnp.linalg.norm(state.pos, axis=1)))
        assert np.max(np.linalg.norm(got["pos"], axis=1)) < 2.0 * r0 + 1.0


def test_migrants_equal_jax(eight_devices):
    """debug_exchange: the per-step count of particles crossing a rank
    boundary equals the JAX package's (step 0 is the entry exchange)."""
    cfg = _dist_cfg(2048)
    mesh, state = start_state(cfg, 8)
    _, _, mig = make_distributed_run(cfg, mesh, 4,
                                     debug_exchange=True)(state)
    _, out = port(8, cfg, state, "distributed", 4, debug_exchange=True)
    assert out["migrants"] == [int(m) for m in np.asarray(mig)]
    assert out["migrants"][0] > out["migrants"][-1]


def test_sharded_run_with_distributed_accel(eight_devices):
    """Five sharded steps with dist_bh_accel (every step re-exchanges):
    equal to the JAX package's, momentum conserved to 5e-3."""
    cfg = _dist_cfg(1024)
    mesh, state = start_state(cfg, 8)
    ref = make_sharded_run(cfg, mesh, 5)(state)
    got, _ = port(8, cfg, state, "run", 5)
    close(got["pos"], ref.pos)
    p0 = np.sum(np.asarray(state.mass)[:, None] * np.asarray(state.vel), 0)
    p1 = np.sum(got["mass"][:, None] * got["vel"], 0)
    mv = np.sqrt(np.sum(np.asarray(state.mass)[:, None]
                        * np.asarray(state.vel) ** 2))
    assert np.linalg.norm(p1 - p0) < 5e-3 * mv


def test_reuse_eligibility_equals_jax():
    cfg = _dist_cfg(1024).replace(bh_rebuild_every=4)
    for c, n in [(cfg, 8), (cfg.replace(bh_comm="let"), 8),
                 (cfg.replace(bh_rebuild_every=1), 8), (cfg, 1),
                 (cfg.replace(force="direct"), 8),
                 (cfg.replace(bh_far_mode="gather"), 8)]:
        assert t_eligible(tcfg(c), n) == _dist_reuse_eligible(c, n)


def test_distributed_reuse_drift_104_steps():
    """The rebuild interval at k = 8 over 104 steps on 8 ranks, f32:
    energy drift against the port's f64 C++ oracle below 1e-5, the gate of
    tests/test_parallel.py:452 (from the JAX package's ICs)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    from parallelnbody_tpu_torch.native import Oracle

    cfg = SimConfig(n=2048, ic="plummer", softening=0.05, dt=1e-3,
                    integrator="leapfrog", force="barnes_hut", theta=0.5,
                    bh_leaf_size=32, bh_near_budget=256, bh_far_budget=256,
                    bh_multipole=2, dtype="float32", bh_distributed=True,
                    bh_rebuild_every=8)
    assert t_eligible(tcfg(cfg), 104)
    state0 = init_simulation(cfg)
    mass = np.asarray(state0.mass)
    oracle = Oracle(g=1.0, softening=0.05)
    e0 = oracle.total_energy(np.asarray(state0.pos), np.asarray(state0.vel),
                             mass)
    outs = ranks(8).run(tasks.sharded, tcfg(cfg).to_json(), arrays(state0),
                        "init")
    start = {k: np.concatenate([o["state"][k] for o in outs])
             for k in ("pos", "vel", "mass", "acc", "pot")}
    start.update(time=outs[0]["state"]["time"], step=outs[0]["state"]["step"])
    outs = ranks(8).run(tasks.sharded, tcfg(cfg).to_json(), start,
                        "distributed", 104)
    assert outs[0]["overflow"] == 0
    assert int(outs[0]["state"]["step"]) == 104
    pos = np.concatenate([o["state"]["pos"] for o in outs])
    vel = np.concatenate([o["state"]["vel"] for o in outs])
    e1 = oracle.total_energy(pos, vel, mass)
    assert abs((e1 - e0) / e0) < 1e-5


def test_graft_paths_at_five_ranks():
    """__graft_entry__.dryrun_multichip's distributed paths at a rank count
    that is no power of two: the per-step distributed step, the persistent
    run per step and at rebuild 2 (with the dt = 0 tail fold), LET per step
    and at rebuild 2; every output finite and at the right step."""
    n_dev = 5
    cfg_d = SimConfig(n=640, ic="plummer", integrator="leapfrog",
                      softening=0.01, dt=1e-3, force="barnes_hut",
                      bh_leaf_size=8, bh_near_budget=64,
                      bh_distributed=True, mesh_shape=(n_dev,))
    state = init_simulation(cfg_d.replace(force="direct"),
                            compute_forces=False)
    cfg_l = cfg_d.replace(bh_comm="let")
    for cfg, program, n_steps in [
            (cfg_d, "step", 1),
            (cfg_d.replace(bh_rebuild_every=1), "distributed", 2),
            (cfg_d.replace(bh_rebuild_every=2), "distributed", 3),
            (cfg_l, "step", 1),
            (cfg_l.replace(bh_rebuild_every=2), "distributed", 2)]:
        got, _ = port(n_dev, cfg, state, program, n_steps)
        assert got["step"] == n_steps
        assert np.all(np.isfinite(got["pos"]))
