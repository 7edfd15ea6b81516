"""The per-phase geometry tools on the CPU against the JAX package and the
TPU scripts: tools/li_profile.py, staged_probe.py, reuse_probe.py,
octet_probe.py and theta_sweep.py.

  * li_profile's stages A-E, composed, give the JAX package's
    `leaf_interactions` lists and overflow exactly, on the JAX tree (so no
    MAC decision flips on the f32 rounding of a pyramid built twice).
  * staged_probe's dense and staged lists (captured as the tool builds
    them, its pyramid the JAX one) and overflow equal the JAX package's
    `leaf_interactions` and `build_interaction_lists_staged`, and its
    printed statistics are those lists'.
  * reuse_probe's reused-list trajectory: the rms against a fresh rebuild
    and against the direct sum at steps 1, 2 and 4 within 1e-5 absolute of
    scripts/reuse_probe.py's `main` (the JAX package's `bh_plan_lists` /
    `bh_eval_lists` in its jit closures) on the same numpy-seeded state.
  * octet_probe's cases are the scripts' `case(...)` calls (read from their
    source), and gather and octet count the same far terms.
  * theta_sweep's rms errors equal the JAX package's `bh_accel` against
    its f32 direct sum on the same particles within 1e-6 absolute.
"""

import ast
import importlib.util
import re
import sys
import types
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
from parallelnbody_tpu_torch.tools import (li_profile, octet_probe,
                                           reuse_probe, staged_probe,
                                           theta_sweep)
from parallelnbody_tpu_torch.tools.bh_breakdown import Spec

torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


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


def _to_torch_tree(jt):
    conv = lambda level: (None if level is None  # noqa: E731
                          else torch.from_numpy(np.array(level)))
    return tbh.BHTree(*(tuple(conv(x) for x in getattr(jt, f))
                        for f in ("com", "mass", "radius", "quad")))


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.fixture(scope="module")
def jax_prepared():
    """The JAX package's _prepare of 16384 seeded Plummer particles at leaf
    64 (256 leaves, 4 levels), and the particles."""
    pos, _, mass = _plummer_np(16384, 5)
    out = jbh._prepare(jnp.asarray(pos), jnp.asarray(mass), leaf_size=64,
                       curve="hilbert", multipole_order=2)
    return out, pos, mass


# near + far >= 249 keeps stage A's budget, ceil((near + far) / 8), at all
# 32 level-1 nodes: A clips nothing while D and E clip.
@pytest.mark.parametrize("theta,near,far", [(0.7, 512, 2048),
                                            (0.5, 64, 192),
                                            (0.72, 40, 216)],
                         ids=["wide", "near-clip", "tight"])
def test_li_profile_stages_compose_to_leaf_interactions(jax_prepared, theta,
                                                        near, far):
    jt = jax_prepared[0][3]
    tt = _to_torch_tree(jt)
    _, jrej = jbh.traverse(jt, theta)
    _, trej = tbh.traverse(tt, theta)
    records, composed = li_profile.profile(tt, trej, theta=theta, near=near,
                                           far=far)
    summary = records[-1]
    assert summary["l1_overflow"] == 0 and summary["lists_equal"]
    want = jbh.leaf_interactions(jt, jrej, theta, start_leaf=0,
                                 n_slice=256, near_budget=near,
                                 far0_budget=far)
    for got, exp, name in zip(composed, want, ("near_idx", "near_valid",
                                               "far0_idx", "far0_valid",
                                               "overflow")):
        _eq(got, exp, name)
    assert summary["overflow"] == int(want[4])
    assert (summary["overflow"] > 0) == (near < 512)
    assert [r["stage"] for r in records[:-1]] == [
        "A l1-compact", "B expand", "C mac gathers", "D near-compact",
        "E far-compact", "raw row sort", "dense masks", "dense near-compact",
        "dense far-compact", "leaf_interactions"]


def test_li_profile_blanks_padding_targets():
    """Zero-mass (padding) target leaves get empty rows in stage B, as in
    leaf_interactions: composed equal at N = 12000 (68 empty leaves)."""
    pos, _, mass = _plummer_np(12000, 6)
    tt = tbh._prepare(torch.from_numpy(pos), torch.from_numpy(mass),
                      leaf_size=64, curve="hilbert", multipole_order=2)[3]
    _, rej = tbh.traverse(tt, 0.7)
    records, composed = li_profile.profile(tt, rej, theta=0.7, near=512,
                                           far=2048)
    assert records[-1]["lists_equal"]
    assert not bool(composed[1][-60:].any())


def _staged_args(**kw):
    args = staged_probe.parser().parse_args(["--device", "cpu"])
    return types.SimpleNamespace(**{**vars(args), **kw})


@pytest.mark.parametrize("near,far,cand1,cand2", [
    (512, 2048, 0, 0), (64, 96, 0, 0), (256, 512, 24, 4)],
    ids=["wide", "clipping", "cand-clipping"])
def test_staged_probe_lists_equal_jax(monkeypatch, jax_prepared, near, far,
                                      cand1, cand2):
    prepared, pos, mass = jax_prepared
    torch_prepared = (*(torch.from_numpy(np.array(a)) for a in prepared[:3]),
                      _to_torch_tree(prepared[3]), *prepared[4:])
    monkeypatch.setattr(tbh, "_prepare", lambda *a, **k: torch_prepared)
    built = {}
    for name in ("leaf_interactions", "build_interaction_lists_staged"):
        fn = getattr(tbh, name)

        def spy(*a, _fn=fn, _name=name, **k):
            built[_name] = _fn(*a, **k)
            return built[_name]
        monkeypatch.setattr(tbh, name, spy)
    args = _staged_args(mode="lists", leaf=64, theta=0.72, near=near,
                        far=far, cand1=cand1, cand2=cand2)
    recs = staged_probe.probe(torch.from_numpy(pos), torch.from_numpy(mass),
                              args)
    jt = prepared[3]
    _, cands = jbh.resolve_refine("staged", (cand2, cand1), jt.n_levels,
                                  near, far)
    _, jrej1 = jbh.traverse(jt, 0.72, stop_level=1)
    dense = jbh.leaf_interactions(jt, jrej1, 0.72, start_leaf=0,
                                  n_slice=256, near_budget=near,
                                  far0_budget=far)
    jfm2, jrej2 = jbh.traverse(jt, 0.72, stop_level=2)
    staged = jbh.build_interaction_lists_staged(
        jt, jfm2, jrej2, theta=0.72, start_leaf=0, n_slice=256,
        near_budget=near, far_budget=far, cand2_budget=cands[0],
        cand1_budget=cands[1], dtype=jnp.float32)
    for got, want in ((built["leaf_interactions"], dense),
                      (built["build_interaction_lists_staged"], staged)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _eq(g, w, f"output {i}")
    by = {r["phase"]: r for r in recs}
    nv, nv2, fv2 = (np.asarray(a) for a in (dense[1], staged[1], staged[3]))
    rej2 = np.asarray(jrej2).sum(1)
    assert by["dense lists"]["overflow"] == int(dense[4])
    assert by["staged lists"]["overflow"] == int(staged[5])
    assert by["dense lists"]["near_max"] == int(nv.sum(1).max())
    assert by["staged lists"]["far_mean"] == float(fv2.sum(1).mean())
    assert by["staged lists"]["near_max"] == int(nv2.sum(1).max())
    assert (by["staged lists"]["rej2_mean"], by["staged lists"]["rej2_max"]
            ) == (float(rej2.mean()), int(rej2.max()))
    assert by["staged lists"]["cand_budgets"] == list(cands)


@pytest.mark.parametrize("mode", ["both", "phases"])
def test_staged_probe_modes_run(mode):
    """The evaluation modes on the plain versions: bh_accel in each
    refinement, or the far field and K1 with and without prebuilt items."""
    pos, _, mass = _plummer_np(4096, 7)
    recs = staged_probe.probe(torch.from_numpy(pos), torch.from_numpy(mass),
                              _staged_args(mode=mode, leaf=32, near=256,
                                           far=512))
    names = [r["phase"] for r in recs]
    tail = (["bh_accel[dense]", "bh_accel[staged]"] if mode == "both" else
            ["K4 far (combined)", "K1 near (items prebuilt)",
             "K1 near (items built in the call)"])
    assert names[-len(tail):] == tail


def test_reuse_probe_trajectory_matches_the_script(monkeypatch, capsys):
    n, k = 4096, 4
    pos, vel, mass = _plummer_np(n, 8)
    monkeypatch.setattr(jmodels, "get_ic", lambda name: (
        lambda key, cfg: (jnp.asarray(pos), jnp.asarray(vel),
                          jnp.asarray(mass))))
    monkeypatch.setattr(sys, "argv", ["reuse_probe.py", "--n", str(n),
                                      "--k", str(k), "--iters", "1"])
    _load("reuse_probe").main()
    out = capsys.readouterr().out
    want = {int(m[1]): (float(m[2]), float(m[3])) for m in re.finditer(
        r"step\s+(\d+): reuse-vs-fresh rms (\S+)\s+vs-direct rms (\S+)",
        out)}
    assert sorted(want) == [1, 2, 4]
    cfg = reuse_probe.make_cfg(n, 1e-4, "plummer").with_resolved_leaf("cpu")
    plan, evaluate, full, refine = reuse_probe.make_plan_eval(cfg)
    assert refine == "dense" and cfg.resolve_bh_leaf_size() == 128
    rows = reuse_probe.trajectory(cfg, *(torch.from_numpy(a) for a in
                                         (pos, vel, mass)), k, plan,
                                  evaluate, full)
    assert [r["step"] for r in rows] == [1, 2, 4]
    for r in rows:
        fresh, direct = want[r["step"]]
        assert abs(r["reuse_vs_fresh_rms"] - fresh) < 1e-5
        assert abs(r["vs_direct_rms"] - direct) < 1e-5


def test_reuse_probe_gates_clipped_runs():
    """A timed run whose lists clipped raises."""
    cfg = reuse_probe.make_cfg(4096, 1e-4, "plummer").replace(
        bh_leaf_size=32, bh_near_budget=4, bh_far_budget=4)
    pos, vel, mass = (torch.from_numpy(a) for a in _plummer_np(4096, 9))
    state = types.SimpleNamespace(pos=pos, vel=vel, mass=mass)
    with pytest.raises(AssertionError, match="clipped lists"):
        reuse_probe.probe(cfg, state, k=1, iters=1)


def _script_cases(name):
    """{set: [(n or None, ic, case keywords)]} from the case(...) calls of
    a TPU script, read from its source."""
    tree = ast.parse((SCRIPTS / f"{name}.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
                and f.name == "main")
    sets = {}

    def walk(stmts, label, state):
        for st in stmts:
            if isinstance(st, ast.If):
                test = st.test
                lab = label
                if (isinstance(test, ast.Compare)
                        and isinstance(test.comparators[0], ast.Constant)):
                    lab = test.comparators[0].value
                walk(st.body, lab, state)
                walk(st.orelse, label, state)
            elif isinstance(st, ast.Assign) and isinstance(
                    st.value, ast.Call) and getattr(
                    st.value.func, "id", "") == "get_state":
                a = st.value.args
                state = (eval(ast.unparse(a[0])), ast.literal_eval(
                    st.value.keywords[0].value) if st.value.keywords
                    else "plummer")
            elif isinstance(st, ast.Expr) and isinstance(
                    st.value, ast.Call) and getattr(
                    st.value.func, "id", "") == "case":
                kw = {k.arg: (None if k.arg == "theta" else
                              ast.literal_eval(k.value))
                      for k in st.value.keywords}
                sets.setdefault(label, []).append((state, kw))

    walk(main.body, "probe", (None, "plummer"))
    return sets


def test_octet_probe_cases_are_the_scripts():
    defaults = dict(near=3584, far=2816, cands=(0, 0), iters=5)
    want = _script_cases("octet_probe")
    want.update(_script_cases("octet_probe2"))
    assert sorted(want) == sorted(octet_probe.SETS)
    for name, rows in want.items():
        got = octet_probe.cases(name)
        assert len(got) == len(rows), name
        for (n, ic, spec, iters), ((wn, wic), kw) in zip(got, rows):
            kw = {**defaults, **{k: v for k, v in kw.items()
                                 if k != "theta"}}
            assert n == (wn or 1048576), name
            assert (ic, spec.leaf, spec.refine, spec.far_mode, spec.near,
                    spec.far, spec.cands, iters) == (
                wic, kw["leaf"], kw["refine"], kw["far_mode"], kw["near"],
                kw["far"], kw["cands"], kw["iters"]), (name, kw)
            assert spec.theta == 0.72 and not spec.compute_pot


def test_octet_probe_counts_the_same_far_terms():
    """Gather and octet, dense and staged list the same accepted nodes:
    equal far terms and near pairs at budgets that clip nothing."""
    pos, _, mass = (torch.from_numpy(a) for a in _plummer_np(4096, 11))
    got = {(refine, far_mode): octet_probe.counts(pos, mass, Spec(
        leaf=32, theta=0.72, near=512, far=1024, refine=refine,
        far_mode=far_mode, compute_pot=False).resolved(4096))
        for refine in ("dense", "staged") for far_mode in ("gather",
                                                           "octet")}
    first = got[("dense", "gather")]
    assert first["far_terms"] > 0 and first["near_pairs"] > 0
    for key, c in got.items():
        assert (c["far_terms"], c["near_pairs"]) == (
            first["far_terms"], first["near_pairs"]), key


def test_octet_probe_records():
    recs = octet_probe.probe("probe", torch.device("cpu"), n=4096,
                             quick=True)
    assert [(r["far_mode"], r["far_kernel"], r["overflow"], r["ms"])
            for r in recs] == [("gather", "K4", 0, None),
                               ("octet", "K2", 0, None)]


def test_theta_sweep_rms_matches_jax(monkeypatch):
    """At leaf 32 (the script's 256 leaves no far node at a CPU size)."""
    pos, _, mass = _plummer_np(4096, 10)
    states = {n: types.SimpleNamespace(pos=torch.from_numpy(pos[:n]),
                                       mass=torch.from_numpy(mass[:n]))
              for n in (4096, 1024)}
    monkeypatch.setattr(theta_sweep, "_state", lambda n, dev: states[n])
    recs = theta_sweep.sweep(torch.device("cpu"), 4096, 1024, 256, 512,
                             leaf=32)
    jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
    ref = direct_accel_at(jpos, jmass, jpos, g=1.0, softening=0.01)
    norm = float(jnp.sqrt(jnp.mean(jnp.sum(ref * ref, axis=1))))
    errs = []
    for r in recs:
        acc, _, of = jbh.bh_accel(jpos, jmass, leaf_size=32,
                                  theta=r["theta"], near_budget=256,
                                  far0_budget=512, multipole=2)
        err = float(jnp.sqrt(jnp.mean(jnp.sum((acc - ref) ** 2, axis=1))))
        assert abs(r["rms_err"] - err / norm) < 1e-6
        assert r["overflow_rms"] == int(of) == 0
        errs.append(r["rms_err"])
    assert errs[0] < errs[-1]
