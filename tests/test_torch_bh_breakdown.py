"""tools/bh_breakdown.py on the CPU against scripts/bh_breakdown.py and
against the port's own bh_accel.

The script is loaded read-only and its `main` run with --lists-only on the
same numpy-seeded particles as the tool (its `init_simulation` replaced by
one that returns them): n_pad, n_leaves, levels, every statistic of the
upper-accepted nodes, level-1 rejects, near and far0 entries a target leaf,
the overflow and the near pairs equal; the leaf radius statistics within
1e-6 relative (each package builds its own f32 pyramid). Then the phases,
composed in every refinement and far mode, equal `bh_accel`'s forces to
rtol 1e-6: they call the same functions in the same order.
"""

import importlib.util
import json
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu_torch.tools import bh_breakdown as tool

_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bh_breakdown.py"
_spec = importlib.util.spec_from_file_location("bh_breakdown_script",
                                               _SCRIPT)
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)   # read-only: the TPU script

torch.set_num_threads(2)

LEAF = 64


def _plummer_np(n, seed):
    cfg = JaxConfig(n=n, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(seed), cfg)
    return np.array(pos), np.array(mass)


def _json_after(text, label, end=None):
    line = next(ln for ln in text.splitlines() if label in ln)
    body = line.split(label, 1)[1]
    if end:
        body = body.split(end, 1)[0]
    return json.loads(body)


def _script_lines(monkeypatch, capsys, pos, mass, near, far):
    state = types.SimpleNamespace(pos=jnp.asarray(pos),
                                  mass=jnp.asarray(mass))
    monkeypatch.setattr(script, "init_simulation", lambda cfg: state)
    monkeypatch.setattr(sys, "argv", [
        "bh_breakdown.py", "--n", str(pos.shape[0]), "--leaf", str(LEAF),
        "--near", str(near), "--far", str(far), "--lists-only"])
    script.main()
    out = capsys.readouterr().out
    prep = re.search(r"n_pad=(\d+), n_leaves=(\d+), levels=(\d+)", out)
    return {
        "n_pad": int(prep[1]), "n_leaves": int(prep[2]),
        "levels": int(prep[3]),
        "upper_accepted": _json_after(out, "upper-accepted/leaf: "),
        "l1_rejects": _json_after(out, "l1-rejects/leaf: "),
        "overflow": int(re.search(r"overflow=(\d+)", out)[1]),
        "near": _json_after(out, "near leaves/target: ", " (budget"),
        "far0": _json_after(out, "far0 leaves/target: ", " (budget"),
        "near_pairs": re.search(r"near pairs total: (\S+)", out)[1],
        "leaf_radius": _json_after(out, "leaf radius: "),
    }


@pytest.mark.parametrize("n,seed,near,far", [
    (16384, 0, 512, 2048), (16384, 1, 24, 64), (12000, 2, 512, 2048)],
    ids=["wide", "clipping", "padded"])
def test_lists_only_statistics_equal_the_script(monkeypatch, capsys, n,
                                                seed, near, far):
    pos, mass = _plummer_np(n, seed)
    want = _script_lines(monkeypatch, capsys, pos, mass, near, far)
    recs = tool.breakdown(torch.from_numpy(pos), torch.from_numpy(mass),
                          tool.Spec(leaf=LEAF, theta=0.7, near=near,
                                    far=far, far_mode="gather"),
                          lists_only=True)
    by = {r["phase"]: r for r in recs}
    got = {**{k: by["prepare"][k] for k in ("n_pad", "n_leaves", "levels")},
           **{k: by["traverse"][k] for k in ("upper_accepted",
                                              "l1_rejects")},
           **{k: by["leaf_interactions"][k] for k in ("overflow", "near",
                                                      "far0")},
           "near_pairs": f"{by['leaf_interactions']['near_pairs']:.3e}"}
    for key, value in got.items():
        assert value == want[key], key
    if near == 24:
        assert got["overflow"] > 0
    rad = by["prepare"]["leaf_radius"]
    for key, value in want["leaf_radius"].items():
        np.testing.assert_allclose(rad[key], value, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("n", [10, 257, 4096])
def test_stats_rule_is_the_scripts(n):
    counts = np.random.default_rng(n).integers(0, 300, n).astype(np.int32)
    got = tool.stats(torch.from_numpy(counts))
    want = script.stats(jnp.asarray(counts))
    for key in ("p50", "p90", "p99", "max"):
        assert got[key] == want[key] and type(got[key]) is int, key
    # The script's mean of int32 counts is an f32 mean, the tool's an f64
    # one: equal where the f32 sum is exact, as for its lines' int64
    # counts.
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-6)


@pytest.mark.parametrize("refine,far_mode", [("dense", "gather"),
                                             ("dense", "octet"),
                                             ("staged", "octet"),
                                             ("staged", "gather")])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_composed_phases_equal_bh_accel(refine, far_mode, compute_pot):
    pos, mass = (torch.from_numpy(a) for a in _plummer_np(4096, 3))
    spec = tool.Spec(leaf=32, theta=0.6, near=96, far=256, refine=refine,
                     far_mode=far_mode, compute_pot=compute_pot
                     ).resolved(4096)
    assert (spec.refine, spec.far_mode) == (refine, far_mode)
    names = []

    def run(name, fn, info=None):
        names.append(name)
        return fn()

    acc, pot, of = tool.phases(pos, mass, spec, run)
    want = spec.accel(pos, mass)
    np.testing.assert_allclose(acc.numpy(), want[0].numpy(), rtol=1e-6,
                               atol=1e-6 * float(want[0].abs().max()))
    np.testing.assert_allclose(pot.numpy(), want[1].numpy(), rtol=1e-6,
                               atol=1e-6 * float(want[1].abs().max()))
    assert int(of) == int(want[2])
    assert ("refresh" in names) == (far_mode == "octet")
    assert names[-2:] == ["K1 near_field", "unsort"]


def test_breakdown_summary_rows():
    """The summary of a CPU run: the composed difference, the overflow and
    the rebuild row's presence in octet mode; no time (None) off the
    card."""
    pos, mass = (torch.from_numpy(a) for a in _plummer_np(4096, 4))
    for far_mode in ("octet", "gather"):
        recs = tool.breakdown(pos, mass, tool.Spec(
            leaf=32, theta=0.6, near=512, far=512, far_mode=far_mode),
            rebuild=4)
        s = recs[-1]
        assert s["summary"] and s["max_abs_diff"] == 0.0
        assert s["overflow"] == 0 and s["per_step_ms"] is None
        assert ("rebuild_ms" in s) == (far_mode == "octet")
        assert all(r.get("ms") is None and r["card"] == "cpu" for r in recs)


def test_tool_needs_the_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        tool.main(["--n", "4096", "--leaf", "64"])
