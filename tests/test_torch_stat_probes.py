"""The list-statistics and MAC probes on the CPU against the TPU scripts,
loaded read-only through importlib, on the JAX package's seeded Plummer
particles at N = 16384, leaf 64 (256 leaves, 4 levels):

  * near_octet_stats: the statistics and the overflow are the script's
    (both lists from the JAX pyramid, so no MAC decision flips on the f32
    rounding of a pyramid built twice);
  * near_refine_probe: `chunk_stats` gives the script's outputs on the
    same inputs, and `group_moments` its moments;
  * cell_leaves_probe: `leaf_stats`'s tiles are the script's and its true
    pairs within rtol 1e-12, for the equal-count leaves and each d_floor;
  * aniso_bounds_probe: `masks_for` gives the script's masks bit for bit
    for every variant on the JAX tree and AABBs, and `eval_sampled` its
    rms within 1e-6 absolute;
  * mac_experiment: `run`'s rms within 1e-6 absolute, p99.9 and max
    within 1e-6 of max(1, value), and its overflow, with the script's
    LEAF / NB / FB set on the loaded copy; `rms_radii` through a
    mixed-radix top level;
  * multipole_order_probe: the table within rtol 1e-12 of the script's
    functions in its order, and printed as the script prints it.
"""

import importlib.util
import io
import json
import re
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallelnbody_tpu.models as jmodels
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.utils.accuracy import direct_accel_at
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.tools import (aniso_bounds_probe,
                                           cell_leaves_probe, mac_experiment,
                                           multipole_order_probe,
                                           near_octet_stats,
                                           near_refine_probe)

torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
N, LEAF = 16384, 64
CPU = torch.device("cpu")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # read-only: the TPU script
    return mod


def _plummer_np(n, seed):
    cfg = JaxConfig(n=n, ic="plummer", dtype="float32")
    return tuple(np.array(a) for a in
                 jmodels.get_ic("plummer")(jax.random.key(seed), cfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch_tree(jt):
    conv = lambda level: None if level is None else _t(level)  # noqa: E731
    return tbh.BHTree(*(tuple(conv(x) for x in getattr(jt, f))
                        for f in ("com", "mass", "radius", "quad")))


@pytest.fixture(scope="module")
def particles():
    return _plummer_np(N, 21)


@pytest.fixture(scope="module")
def jax_prepared(particles):
    """The JAX package's _prepare at leaf 64 with quadrupoles, as numpy /
    JAX trees."""
    pos, _, mass = particles
    return jbh._prepare(jnp.asarray(pos), jnp.asarray(mass), leaf_size=LEAF,
                        curve="hilbert", multipole_order=2)


def _torch_prepared(prepared):
    return (*(_t(a) for a in prepared[:3]), _to_torch_tree(prepared[3]),
            *prepared[4:])


def _patch_state(monkeypatch, mod, particles):
    pos, vel, mass = particles
    state = types.SimpleNamespace(pos=jnp.asarray(pos), mass=jnp.asarray(mass))
    monkeypatch.setattr(mod, "init_simulation", lambda cfg: state)


@pytest.mark.parametrize("near,far", [(256, 256), (64, 96)],
                         ids=["wide", "clipping"])
def test_near_octet_stats_equal_the_script(monkeypatch, particles,
                                           jax_prepared, near, far):
    script = _load("near_octet_stats")
    _patch_state(monkeypatch, script, particles)
    monkeypatch.setattr(script.bh, "_prepare",
                        lambda *a, **k: jax_prepared)
    monkeypatch.setattr(sys, "argv", [
        "near_octet_stats.py", "--n", str(N), "--leaf", str(LEAF),
        "--near", str(near), "--far", str(far)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        script.main()
    lines = buf.getvalue().strip().splitlines()
    head = dict(re.findall(r"(\w+)=(\d+)", lines[0]))
    want = json.loads(lines[-1])

    monkeypatch.setattr(tbh, "_prepare",
                        lambda *a, **k: _torch_prepared(jax_prepared))
    args = near_octet_stats.parser().parse_args(
        ["--n", str(N), "--leaf", str(LEAF), "--near", str(near), "--far",
         str(far), "--device", "cpu"])
    pos, _, mass = particles
    got = near_octet_stats.stats(_t(pos), _t(mass), args)[-1]
    assert (got["n_leaves"], got["overflow"]) == (int(head["n_leaves"]),
                                                  int(head["overflow"]))
    assert (got["overflow"] > 0) == (near < 256)
    assert {k: got[k] for k in want} == want


def test_near_refine_chunk_stats_equal_the_script(particles):
    script = _load("near_refine_probe")
    pos, _, mass = particles
    pos_s, mass_s, _, tree, _, n_pad = jbh._prepare(
        jnp.asarray(pos), jnp.asarray(mass), leaf_size=LEAF,
        curve="hilbert")
    leaf_com, leaf_r = tree.com[0], tree.radius[0]
    for sub, t0 in ((16, 0), (32, 128)):
        spl = LEAF // sub
        jmom = script.group_moments(pos_s, mass_s, sub)
        tmom = near_refine_probe.group_moments(_t(pos_s), _t(mass_s), sub)
        for j, t in zip(jmom, tmom):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6,
                                       atol=1e-7)
        sub_com, sub_r = jmom[0], jmom[1]
        chunk = slice(t0, t0 + 128)
        want = script.chunk_stats(leaf_com[chunk], leaf_r[chunk], leaf_com,
                                  leaf_r, sub_com, sub_r, theta=0.72,
                                  sub_per_leaf=spl)
        got = near_refine_probe.chunk_stats(
            *(_t(a) for a in (leaf_com[chunk], leaf_r[chunk], leaf_com,
                              leaf_r, sub_com, sub_r)),
            theta=0.72, sub_per_leaf=spl)
        assert int(np.asarray(want[0]).sum()) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"sub {sub} output {i}")


def test_near_refine_probe_records(particles):
    pos, _, mass = particles
    args = near_refine_probe.parser().parse_args(
        ["--leaf", str(LEAF), "--chunk", "128", "--device", "cpu"])
    recs = near_refine_probe.probe(_t(pos), _t(mass), args)
    assert recs[0]["k1_pairs_per_s"] is None
    assert [r["sub"] for r in recs[1:]] == [32, 64]
    for r in recs[1:]:
        assert r["ms_eq_cur"] is None and r["near_leaf_entries"] > 0
        assert r["pairs_cur"] >= r["pairs_ref"]
    assert [f["top"] for f in recs[1]["fattest"]] == [8, 32, 128]


def test_cell_leaves_stats_equal_the_script(monkeypatch, particles, capsys):
    script = _load("cell_leaves_probe")
    pos, vel, mass = particles
    monkeypatch.setattr(script, "get_ic", lambda name: (
        lambda key, cfg: (jnp.asarray(pos), jnp.asarray(vel),
                          jnp.asarray(mass))))
    seen = []
    leaf_stats = script.leaf_stats

    def spy(name, *a):
        seen.append((name, *leaf_stats(name, *a)))
        return seen[-1][1:]
    monkeypatch.setattr(script, "leaf_stats", spy)
    monkeypatch.setattr(sys, "argv", ["cell_leaves_probe.py", "--n", str(N),
                                      "--g", str(LEAF)])
    script.main()
    capsys.readouterr()
    args = cell_leaves_probe.parser().parse_args(
        ["--g", str(LEAF), "--device", "cpu"])
    recs = cell_leaves_probe.probe(_t(pos), _t(mass), args)
    assert recs[0]["k1_pairs_per_s"] is None
    got = [(r["structure"], r["tiles"], r["true_pairs"]) for r in recs[1:]]
    assert [g[0] for g in got] == [s[0] for s in seen] == [
        "equal-count", "cell d_floor=0", "cell d_floor=3", "cell d_floor=4",
        "cell d_floor=5"]
    for (name, tiles, pairs), (_, w_tiles, w_pairs) in zip(got, seen):
        assert tiles == w_tiles, name
        assert pairs == pytest.approx(w_pairs, rel=1e-12), name
        assert recs[1]["padded_ms"] is None


@pytest.fixture(scope="module")
def aniso(jax_prepared):
    script = _load("aniso_bounds_probe")
    pos_s, mass_s, _, tree, _, _ = jax_prepared
    ext = script.node_aabbs(pos_s, mass_s, LEAF, tree)
    return script, ext


@pytest.mark.parametrize("variant", ["iso", "target", "both"])
def test_aniso_masks_equal_the_script(aniso, jax_prepared, variant):
    script, (ja, jb) = aniso
    jt = jax_prepared[3]
    tt = _to_torch_tree(jt)
    ta, tb = aniso_bounds_probe.node_aabbs(_t(jax_prepared[0]),
                                           _t(jax_prepared[1]), LEAF, tt)
    for x, y in zip(ta + tb, ja + jb):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    ta, tb = [_t(a) for a in ja], [_t(b) for b in jb]
    for theta in (0.6, 0.84):
        jfar, jnear = script.masks_for(jt, ja, jb, theta, variant)
        tfar, tnear = aniso_bounds_probe.masks_for(tt, ta, tb, theta,
                                                   variant)
        np.testing.assert_array_equal(tnear.numpy(), np.asarray(jnear))
        assert int(tnear.sum()) > 0
        for k, (t, j) in enumerate(zip(tfar, jfar)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{variant} level {k}")


def test_aniso_eval_sampled_rms_matches_the_script(aniso, jax_prepared):
    script, (ja, jb) = aniso
    pos_s, mass_s, _, jt, _, _ = jax_prepared
    jfar, jnear = script.masks_for(jt, ja, jb, 0.72, "both")
    want, n_want = script.eval_sampled(jt, jfar, jnear, pos_s, mass_s, LEAF,
                                       16, 1.0, 0.01)
    tt = _to_torch_tree(jt)
    tfar, tnear = aniso_bounds_probe.masks_for(
        tt, [_t(a) for a in ja], [_t(b) for b in jb], 0.72, "both")
    got, n_got, held = aniso_bounds_probe.eval_sampled(
        tt, tfar, tnear, _t(pos_s), _t(mass_s), LEAF, 16, 1.0, 0.01)
    assert n_got == n_want and held is None
    assert abs(got - want) < 1e-6 and got > 1e-5


@pytest.mark.parametrize("mode,k,near,far", [("geom", 0.0, 256, 256),
                                             ("rms", 2.0, 48, 64)],
                         ids=["geom", "rms2-clipping"])
def test_mac_experiment_run_matches_the_script(particles, mode, k, near,
                                               far):
    script = _load("mac_experiment")
    script.LEAF, script.NB, script.FB = LEAF, near, far
    pos, _, mass = particles
    jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
    ref = np.asarray(direct_accel_at(jpos, jmass, jpos, g=1.0,
                                     softening=0.01))
    want = script.run(types.SimpleNamespace(pos=jpos, mass=jmass), mode, k,
                      N, ref=ref)
    got = mac_experiment.run(_t(pos), _t(mass), mode, k, leaf=LEAF,
                             near=near, far=far, ref=_t(ref))
    assert got["ovf"] == want["ovf"]
    assert (got["ovf"] > 0) == (near < 256)
    # The clipped lists' p99.9 and max errors exceed 1 (missing near
    # leaves): there 1e-6 of the value, f32 rounding of the forces.
    for key in ("rms", "p999", "max"):
        assert abs(got[key] - want[key]) < 1e-6 * max(1.0, want[key]), key
    assert (got["rms"] < 5e-3) == (near == 256)


def test_mac_experiment_rms_radii_mixed_radix():
    """N = 3 * 2^12 at leaf 64: 192 leaves, levels 192 / 24 / 3 / 1, the
    top level of 3 children; the radii equal the script's."""
    script = _load("mac_experiment")
    script.LEAF = LEAF
    pos, _, mass = _plummer_np(3 * 4096, 22)
    pos_s, mass_s, _, jt, _, _ = jbh._prepare(
        jnp.asarray(pos), jnp.asarray(mass), leaf_size=LEAF,
        curve="hilbert", multipole_order=2)
    widths = [c.shape[0] for c in jt.com]
    want = script.rms_radii(pos_s, mass_s, jt)
    got = mac_experiment.rms_radii(_t(pos_s), _t(mass_s),
                                   _to_torch_tree(jt), LEAF)
    assert len(got) == len(want) == len(widths) and widths[-2] in (2, 3, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def _script_table(script):
    """The script's errors through its own functions, in main's order."""
    alphas = np.array(multipole_order_probe.ALPHAS)
    errs = {1: [], 2: [], 3: []}
    for _ in range(40):
        p, m = script.plummer_clump()
        M, com, r, Q, O = script.moments(p, m)
        for al in alphas:
            for _ in range(8):
                u = script.rng.normal(size=3)
                u /= np.linalg.norm(u)
                x = com + al * r * u
                ex = script.exact_acc(x, p, m)
                nrm = np.linalg.norm(ex)
                for order in (1, 2, 3):
                    ap = script.approx_acc(x, com, M, Q, O, order)
                    errs[order].append((al, np.linalg.norm(ap - ex) / nrm))
    return np.array([[np.sqrt((np.array([e for a, e in errs[o] if a == al])
                               ** 2).mean()) for o in (1, 2, 3)]
                     for al in alphas])


def test_multipole_order_table_matches_the_script(capsys):
    want = _script_table(_load("multipole_order_probe"))
    recs = multipole_order_probe.probe(np.random.default_rng(0), CPU)
    capsys.readouterr()
    got = np.array([[r["mono_rms"], r["quad_rms"], r["oct_rms"]]
                    for r in recs[:10]])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # The script's printout, from the tool's table and thresholds.
    _load("multipole_order_probe").main()
    printed = capsys.readouterr().out.rstrip("\n").splitlines()
    lines = [f"{'alpha':>6} | {'mono rms':>10} {'quad rms':>10} "
             f"{'oct rms':>10}"]
    lines += [f"{al:6.2f} | {a:10.2e} {b:10.2e} {c:10.2e}"
              for al, (a, b, c) in zip(multipole_order_probe.ALPHAS, got)]
    for rec in recs[10:12]:
        parts = [f"order{o}: theta<={rec[f'order{o}_theta']:.2f}"
                 if rec[f"order{o}_theta"] else f"order{o}: n/a"
                 for o in (1, 2, 3)]
        lines.append(f"rms<{rec['target']:g}: " + "  ".join(parts))
    assert printed == lines
