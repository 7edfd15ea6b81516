"""The multi-rank probes on CPU ranks against the JAX package and its
scripts: tools/dist_collectives_probe.py, exchange_volume_probe.py and
dist_production_probe.py, and the collective counter of
parallel/mesh.py RingGroup.

  * Collectives (N = 2048, P = 4, 8 steps, k = 4, ring and LET, per step
    and at the rebuild interval): the structural counts the port's counter
    gives equal those derived from scripts/dist_collectives_probe.py's
    `count_collectives` on the JAX program's jaxpr, and no collective of
    that jaxpr sits inside a `cond` (where the walk would count both
    branches and a run only one).
  * Exchange volume (the script's `run_case` on 4 virtual devices, the
    same JAX ICs, N = 2048, 12 steps, f32): the entry exchange is equal,
    and every later step's migrant fraction agrees within 2 / N (a
    particle or two: each package integrates its own f32 trajectory).
  * Production probe at N = 8192 (leaf 32, budgets that do not clip, k =
    2): overflow 0 both ways, ring and LET agree with each other as
    closely as the JAX package's two runs do (the max |delta pos| within
    a factor 10 of JAX's, or both below 1e-6), and the same rms class.
    The script's `main` cannot run on this JAX (its rms sample indexes a
    sharded array), so the test drives the JAX runs the script drives.
  * At world size 1 no collective runs and none is counted.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from parallelnbody_tpu.api import init_simulation
from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.parallel import make_ring_mesh, shard_state
from parallelnbody_tpu.parallel.distributed import make_distributed_run
from parallelnbody_tpu.parallel.sharded import sharded_init_accel
from parallelnbody_tpu_torch.parallel import RankPool, RingGroup, tasks
from parallelnbody_tpu_torch.tools import dist_collectives_probe as coll
from parallelnbody_tpu_torch.tools import dist_production_probe as prod
from parallelnbody_tpu_torch.tools import exchange_volume_probe as xvol

torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
CPU = torch.device("cpu")
P = 4


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # read-only: the TPU script
    return mod


@pytest.fixture(scope="module")
def pool():
    with RankPool(P, "cpu", timeout=120.0) as p:
        yield p


def _jcfg(cfg):
    return SimConfig(**dataclasses.asdict(cfg))


def _arrays(state):
    return {k: np.array(getattr(state, k))
            for k in ("pos", "vel", "mass", "acc", "pot", "time", "step")}


def _conds_with_collectives(jaxpr, script):
    """Collectives inside the branches of every cond of a jaxpr."""
    found = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "cond":
            found += sum(sum(script.count_collectives(b.jaxpr).values())
                         for b in eqn.params["branches"])
        for sub in eqn.params.values():
            subs = sub if isinstance(sub, (list, tuple)) else [sub]
            for s in subs:
                if hasattr(s, "jaxpr"):
                    found += _conds_with_collectives(s.jaxpr, script)
                elif hasattr(s, "eqns"):
                    found += _conds_with_collectives(s, script)
    return found


@pytest.mark.parametrize("comm", ["ring", "let"])
def test_structural_counts_equal_the_jax_program(eight_devices, pool, comm):
    script = _load("dist_collectives_probe")
    n, steps, k = 2048, 8, 4
    mesh = make_ring_mesh(P)
    for rebuild in (1, k):
        cfg = coll.make_cfg(n, comm).replace(bh_rebuild_every=rebuild)
        jcfg = _jcfg(cfg)
        state = shard_state(init_simulation(jcfg, compute_forces=False),
                            mesh)
        jaxpr = jax.make_jaxpr(make_distributed_run(jcfg, mesh, steps))(
            state)
        assert _conds_with_collectives(jaxpr.jaxpr, script) == 0
        jax_counts = script.count_collectives(jaxpr.jaxpr)
        kw = dict(comm=comm, reuse=rebuild > 1, n_ranks=P)
        want = coll.structure(jax_counts, "jax", **kw)
        counts, _, overflow = coll.count_run(pool, cfg, steps)
        got = coll.structure(counts, "port", **kw)
        assert got == want, (rebuild, counts, jax_counts)
        assert coll.compose(got, "jax") == jax_counts
        assert overflow == 0
        blocks = -(-steps // rebuild) if rebuild > 1 else steps
        assert (got["repartitions"], got["evaluations"]) == (blocks, steps)


def test_probe_records(pool):
    recs = coll.probe(pool, 1024, 4, 2, ["ring", "let"], CPU)
    runs = [(r["comm"], r["run"]) for r in recs[:-1]]
    assert runs == [("ring", "per_step_run"), ("ring", "reuse_run"),
                    ("let", "per_step_run"), ("let", "reuse_run")]
    for r in recs[:-1]:
        assert r["total"] == sum(r["counts"].values())
        assert r["jax_equivalent_total"] > r["total"]
    red = recs[-1]["reduction"]
    assert 0 < red["ring"]["port"] < 1 and 0 < red["let"]["port"] < 1


def test_exchange_volume_matches_the_script(eight_devices, pool):
    script = _load("exchange_volume_probe")
    name, cfg = xvol.cases(2048, 0.004, 0.9, 1.0, 4.0)[1]
    jcfg = _jcfg(cfg)
    want = script.run_case(name, jcfg, 12, n_dev=P)
    ics = _arrays(init_simulation(jcfg, compute_forces=False))
    got = xvol.run_case(pool, name, cfg, 12, CPU, arrays=ics)
    assert got["overflow"] == want["overflow"] == 0
    assert got["entry_exchange_frac"] == want["entry_exchange_frac"]
    # The script prints fractions; its per-step series is its
    # make_distributed_run's migrants.
    state = sharded_init_accel(jcfg, make_ring_mesh(P), shard_state(
        init_simulation(jcfg, compute_forces=False), make_ring_mesh(P)))
    _, _, mig = make_distributed_run(jcfg, make_ring_mesh(P), 12,
                                     debug_exchange=True)(state)
    mig = np.asarray(mig)
    assert got["migrants"][0] == int(mig[0])
    assert np.max(np.abs(np.asarray(got["migrants"][1:]) - mig[1:])) <= 2
    for key in ("steady_mean_frac", "steady_p90_frac", "steady_max_frac"):
        assert abs(got[key] - want[key]) <= 2 / cfg.n, key


def test_exchange_volume_raises_on_overflow(pool):
    name, cfg = xvol.cases(1024, 0.004, 0.9, 0.0, 0.05)[0]
    with pytest.raises(AssertionError, match="broken run"):
        xvol.run_case(pool, name, cfg.replace(bh_near_budget=2), 2, CPU)


def test_production_probe_ring_and_let_agree(eight_devices, pool):
    cfg = prod.make_cfg(8192, 32, 320, 1024, 2)
    jcfg = _jcfg(cfg)
    ics = init_simulation(jcfg, compute_forces=False)
    rep = prod.probe(pool, cfg, 4, CPU, arrays=_arrays(ics))
    mesh = make_ring_mesh(P)
    state = sharded_init_accel(jcfg, mesh, shard_state(ics, mesh))
    jpos = {}
    for comm in ("ring", "let"):
        out, of = make_distributed_run(jcfg.replace(bh_comm=comm), mesh,
                                       4)(state)
        assert int(of) == 0
        jpos[comm] = np.asarray(out.pos)
    jdv = float(np.max(np.abs(jpos["ring"] - jpos["let"])))
    dv = rep["ring_vs_let_max_pos_diff"]
    assert rep["ring"]["overflow"] == rep["let"]["overflow"] == 0
    assert rep["per_step"]["overflow"] == 0
    assert rep["ring"]["steps_done"] == rep["let"]["steps_done"] == 4
    assert dv <= max(10 * jdv, 1e-6) and (jdv <= max(10 * dv, 1e-6))
    for comm in ("ring", "let"):
        assert 0 < rep[comm]["rms_force_error"] < 2e-3
    assert rep["per_step"]["migrants_entry"] > 0


def test_counter_is_empty_at_world_size_one():
    group = RingGroup(0, 1, CPU, "gloo")
    t = torch.arange(4.0)
    group.all_gather(t)
    group.all_to_all(t)
    group.all_reduce(t, "max")
    group.shift_start(t).wait()
    group.broadcast(t)
    assert group.collectives == {}
    with RankPool(1, "cpu", timeout=60.0) as one:
        cfg = coll.make_cfg(512, "ring")
        one.run(tasks.sharded, cfg.to_json(), None, "distributed", 2)
        from parallelnbody_tpu_torch.parallel import mesh

        assert mesh.LAST_RANK_STATS[0]["collectives"] == {}
