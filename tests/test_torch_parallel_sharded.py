"""The port's sharded step on CPU ranks (parallelnbody_tpu_torch.parallel:
the ring all-pairs schedule and the replicated-tree Barnes-Hut, gloo) held
against the JAX package's on its 8 virtual CPU devices, on the same inputs:
the tests of tests/test_parallel.py up to the distributed Barnes-Hut, and
paths 1 and 2 of __graft_entry__.dryrun_multichip.

The ranks are spawned processes (parallel/mesh.RankPool), kept across the
cases of one rank count; each case has its own deadline. States go to the
ranks as numpy arrays and come back per rank. Forces and trajectories: rtol
1e-9 in f64, as tests/test_parallel.py holds the sharded against the
single-device JAX paths; integer outputs (overflow counts) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.api import init_simulation, make_step
from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.parallel import (make_ring_mesh, make_sharded_run,
                                        make_sharded_step, shard_state)
from parallelnbody_tpu.parallel.sharded import (sharded_bh_overflow,
                                                sharded_init_accel)
from parallelnbody_tpu_torch import SimConfig as TorchConfig
from parallelnbody_tpu_torch.parallel import RankPool, tasks
from parallelnbody_tpu_torch.parallel.mesh import mesh_world_size

torch.set_num_threads(2)

CFG = SimConfig(n=512, ic="plummer", dt=1e-3, softening=0.02,
                force="direct", dtype="float64")
DEADLINE = 90.0
_POOL = {}


@pytest.fixture(scope="module", autouse=True)
def _close_pool():
    yield
    for pool in _POOL.values():
        pool.close()
    _POOL.clear()


def ranks(n):
    """A pool of n CPU ranks; the previous pool of another size closes."""
    if n not in _POOL or _POOL[n].closed:
        for pool in _POOL.values():
            pool.close()
        _POOL.clear()
        _POOL[n] = RankPool(n, "cpu", timeout=DEADLINE)
    return _POOL[n]


def arrays(state):
    return {k: np.asarray(getattr(state, k))
            for k in ("pos", "vel", "mass", "acc", "pot", "time", "step")}


def port(n_dev, cfg, state, program, n_steps=1):
    """Run a sharded program of the port on n_dev ranks; returns
    (whole state as numpy arrays, per-rank outputs)."""
    outs = ranks(n_dev).run(tasks.sharded, TorchConfig(**_fields(cfg))
                            .to_json(), arrays(state), program, n_steps)
    if "state" not in outs[0]:
        return None, outs
    whole = {k: np.concatenate([o["state"][k] for o in outs])
             for k in ("pos", "vel", "mass", "acc", "pot")}
    whole["step"] = outs[0]["state"]["step"]
    return whole, outs


def _fields(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def close(a, b, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def test_mesh_world_size():
    assert mesh_world_size(()) == 1
    assert mesh_world_size((8,)) == 8
    assert mesh_world_size((4, 2)) == 8


def test_ring_accel_matches_jax(eight_devices):
    """t = 0 ring forces of the port equal the JAX package's sharded ones
    and its single-device direct sum."""
    state = init_simulation(CFG)
    zero = state._replace(acc=jnp.zeros_like(state.acc),
                          pot=jnp.zeros_like(state.pot))
    mesh = make_ring_mesh(8)
    ref = sharded_init_accel(CFG, mesh, shard_state(zero, mesh))
    got, _ = port(8, CFG, zero, "init")
    close(got["acc"], ref.acc, 1e-10, 1e-10)
    close(got["pot"], ref.pot, 1e-10, 1e-10)
    close(got["acc"], state.acc, 1e-10, 1e-10)


def test_sharded_step_and_run_match_jax(eight_devices):
    """Five sharded steps (make_sharded_step) and a ten-step sharded run
    (make_sharded_run) equal the JAX package's single-device steps."""
    state = init_simulation(CFG)
    step = make_step(CFG)
    ref = state
    for _ in range(5):
        ref = step(ref)
    got, outs = port(8, CFG, state, "step", 5)
    close(got["pos"], ref.pos)
    close(got["vel"], ref.vel)
    assert int(got["step"]) == 5 and outs[0]["overflow"] == 0
    mesh = make_ring_mesh(8)
    ref10 = make_sharded_run(CFG, mesh, 10)(shard_state(state, mesh))
    got, _ = port(8, CFG, state, "run", 10)
    assert int(got["step"]) == 10
    close(got["pos"], ref10.pos)


def test_sharded_energy_conservation(eight_devices):
    """100 sharded leapfrog steps conserve energy to 1e-4, and end where
    the JAX package's sharded run ends."""
    from parallelnbody_tpu.ops.energy import total_energy

    cfg = CFG.replace(integrator="leapfrog")
    state = init_simulation(cfg)
    e0 = float(total_energy(state.vel, state.mass, state.pot))
    got, _ = port(8, cfg, state, "run", 100)
    e1 = float(total_energy(jnp.asarray(got["vel"]), jnp.asarray(got["mass"]),
                            jnp.asarray(got["pot"])))
    assert abs((e1 - e0) / e0) < 1e-4
    mesh = make_ring_mesh(8)
    ref = make_sharded_run(cfg, mesh, 100)(shard_state(state, mesh))
    close(got["pos"], ref.pos, 1e-8, 1e-11)


def test_multislice_mesh_4x2(eight_devices):
    """A (4, 2) mesh_shape is 8 ranks in slice-major order; its sharded
    step equals the JAX package's on make_multislice_ring_mesh(4, 2)."""
    from parallelnbody_tpu.parallel.mesh import make_multislice_ring_mesh

    cfg = CFG.replace(mesh_shape=(4, 2))
    n_dev = mesh_world_size(TorchConfig(**_fields(cfg)).mesh_shape)
    assert n_dev == 8
    state = init_simulation(CFG)
    mesh = make_multislice_ring_mesh(4, 2)
    ref = make_sharded_step(CFG, mesh)(shard_state(state, mesh))
    got, _ = port(n_dev, cfg, state, "step")
    close(got["pos"], ref.pos)


def test_sharded_bh_matches_jax(eight_devices):
    """Replicated-tree Barnes-Hut: the port's sharded step equals the JAX
    package's sharded step and its single-device step."""
    cfg = SimConfig(n=2048, ic="plummer", dt=1e-3, softening=0.02,
                    force="barnes_hut", bh_leaf_size=32, bh_near_budget=256,
                    dtype="float64")
    mesh = make_ring_mesh(8)
    state = init_simulation(cfg)
    ref = make_sharded_step(cfg, mesh)(shard_state(state, mesh))
    single = make_step(cfg)(state)
    got, outs = port(8, cfg, state, "step")
    close(got["acc"], ref.acc)
    close(got["pos"], single.pos)
    close(got["acc"], single.acc, 1e-7, 1e-10)
    assert outs[0]["overflow"] == 0


def test_sharded_bh_init_and_virialize(eight_devices):
    """sharded_init_accel fills acc like the JAX package's; with virialize
    a fresh state ends with 2K + W ~ 0, and a stepped state is not
    rescaled."""
    from parallelnbody_tpu.ops.energy import kinetic_energy, potential_energy

    cfg = SimConfig(n=2048, ic="plummer", softening=0.02,
                    force="barnes_hut", bh_leaf_size=32, bh_near_budget=256,
                    dtype="float64")
    mesh = make_ring_mesh(8)
    state = init_simulation(cfg)
    zero = state._replace(acc=jnp.zeros_like(state.acc),
                          pot=jnp.zeros_like(state.pot))
    ref = sharded_init_accel(cfg, mesh, shard_state(zero, mesh))
    got, _ = port(8, cfg, zero, "init")
    close(got["acc"], ref.acc)
    close(got["acc"], state.acc, 1e-7, 1e-10)

    vcfg = CFG.replace(virialize=True)
    fresh = init_simulation(vcfg, compute_forces=False)
    got, _ = port(8, vcfg, fresh, "init")
    ke = float(kinetic_energy(jnp.asarray(got["vel"]),
                              jnp.asarray(got["mass"])))
    w = float(potential_energy(jnp.asarray(got["pot"]),
                               jnp.asarray(got["mass"])))
    assert abs(2 * ke + w) / abs(w) < 1e-6
    jref = sharded_init_accel(vcfg, mesh, shard_state(fresh, mesh))
    close(got["vel"], jref.vel)
    stepped = fresh._replace(step=fresh.step + 1, vel=fresh.vel * 2.0)
    got, _ = port(8, vcfg, stepped, "init")
    np.testing.assert_array_equal(got["vel"], np.asarray(stepped.vel))


def test_sharded_bh_overflow_counts_equal_jax(eight_devices):
    """Under-budgeted replicated-tree Barnes-Hut reports the JAX package's
    overflow (nonzero), at the audit and mid-run; roomy budgets report 0."""
    base = SimConfig(n=2048, ic="plummer", softening=0.02,
                     force="barnes_hut", bh_leaf_size=8, dtype="float64")
    mesh = make_ring_mesh(8)
    state = init_simulation(base.replace(force="direct"))
    tight = base.replace(bh_near_budget=2, bh_far_budget=8)
    want = sharded_bh_overflow(tight, mesh, shard_state(state, mesh))
    assert want > 0
    _, outs = port(8, tight, state, "overflow")
    assert outs[0]["overflow"] == want
    _, of = make_sharded_step(tight, mesh, report_overflow=True)(
        shard_state(state, mesh))
    _, outs = port(8, tight, state, "step")
    assert outs[0]["overflow"] == int(of) > 0
    roomy = base.replace(bh_near_budget=256, bh_far_budget=1024)
    _, outs = port(8, roomy, state, "overflow")
    assert outs[0]["overflow"] == 0


def test_ring_with_k3_tile_on_cpu(eight_devices):
    """force="direct_pallas" takes K3's wrapper as the ring's tile (its
    plain version on the CPU): equal, in f32, to the JAX package's ring
    with the Pallas tile in interpret mode."""
    from jax.sharding import PartitionSpec as P

    from parallelnbody_tpu.ops.pallas_direct import pallas_accel_tile
    from parallelnbody_tpu.parallel.ring import ring_accel

    cfg = SimConfig(n=512, ic="plummer", softening=0.02, dtype="float32",
                    force="direct_pallas")
    state = init_simulation(cfg.replace(force="direct"))
    mesh = make_ring_mesh(8)

    def local(pos, mass):
        return ring_accel(pos, mass, g=1.0, softening=0.02,
                          tile_fn=lambda pi, pj, mj: pallas_accel_tile(
                              pi, pj, mj, g=1.0, softening=0.02, tile_i=32,
                              tile_j=128, interpret=True))

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("ring"), P("ring")),
                       out_specs=(P("ring"), P("ring")), check_vma=False)
    acc, pot = jax.jit(fn)(state.pos, state.mass)
    got, _ = port(8, cfg, state, "init")
    close(got["acc"], acc, 2e-4, 2e-5)
    close(got["pot"], pot, 2e-4, 2e-5)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_chip_count_invariance(eight_devices, n_dev):
    """The sharded step at 1, 2 and 4 ranks equals the JAX package's
    single-device step (8 ranks: the tests above)."""
    state = init_simulation(CFG)
    got, _ = port(n_dev, CFG, state, "step")
    ref = make_step(CFG)(state)
    close(got["pos"], ref.pos)


@pytest.mark.parametrize("n_dev", [3, 5, 7])
def test_sharded_bh_any_rank_count(eight_devices, n_dev):
    """Rank counts that do not divide the leaf count (trailing windows
    clamp and overlap), and __graft_entry__'s paths 1 (ring) and 2
    (replicated tree) at that count: equal to the JAX package's step."""
    cfg = SimConfig(n=64 * n_dev, ic="plummer", dt=1e-3, softening=0.02,
                    force="barnes_hut", bh_leaf_size=8, bh_near_budget=64,
                    dtype="float64")
    state = init_simulation(cfg)
    ref = make_step(cfg)(state)
    got, _ = port(n_dev, cfg, state, "step")
    close(got["acc"], ref.acc, 1e-7, 1e-10)
    ring = cfg.replace(force="direct")
    got, _ = port(n_dev, ring, state, "step")
    close(got["pos"], make_step(ring)(state).pos)
