"""The auto leaf size by device (config.py SimConfig.resolve_bh_leaf_size,
AUTO_LEAF128_MAX_N_CUDA) and its one resolution at the entry points
(SimConfig.with_resolved_leaf): on the CPU the JAX package's rule, on a
CUDA device the card's; the config that the plan and the evaluation read
holds the resolved leaf; a checkpoint stores it and resumes to the same
bits. No card needed: where a device is named "cuda" it is only a name,
and the functions called build their closures without touching a tensor
on it."""

import json
import types

import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu_torch import SimConfig, api
from parallelnbody_tpu_torch.cli import main as tmain
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.utils.io import latest_checkpoint, load_checkpoint

torch.set_num_threads(2)

CARD_TOP = SimConfig.AUTO_LEAF128_MAX_N_CUDA
BOUNDARY_N = sorted({1 << 19, (1 << 19) + 1, 1 << 20, (1 << 20) + 1,
                     CARD_TOP, CARD_TOP + 1, 1 << 23, (1 << 23) + 1})


@pytest.mark.parametrize("n", BOUNDARY_N)
def test_leaf_rule_by_device(n):
    """'cpu' (and no device) resolves as the JAX package does; 'cuda' to
    128 up to AUTO_LEAF128_MAX_N_CUDA and 256 above; the refinement
    follows the leaf resolved for the same device; an explicit leaf
    stands on both."""
    cfg, jcfg = SimConfig(n=n), JaxConfig(n=n)
    assert cfg.resolve_bh_leaf_size() == jcfg.resolve_bh_leaf_size()
    assert cfg.resolve_bh_leaf_size("cpu") == jcfg.resolve_bh_leaf_size()
    assert cfg.resolve_bh_refine("cpu") == jcfg.resolve_bh_refine()
    card = cfg.resolve_bh_leaf_size("cuda")
    assert card == (128 if n <= CARD_TOP else 256)
    assert cfg.resolve_bh_leaf_size(torch.device("cuda", 0)) == card
    n_leaves = bh.plan_tree(n, card)[0]
    assert cfg.resolve_bh_refine("cuda") == ("staged" if n_leaves >= 8192
                                             else "dense")
    pinned = cfg.replace(bh_leaf_size=64)
    for device in ("cpu", "cuda"):
        assert pinned.resolve_bh_leaf_size(device) == 64


def test_the_card_rule_keeps_128_to_2e20_at_least():
    """tools/auto_rules.py leaf measured leaf 128 ahead of 256 on the card
    at N = 2^20 (PERF.md): the card's rule takes 128 there, where the
    CPU's takes 256."""
    cfg = SimConfig(n=1 << 20)
    assert cfg.resolve_bh_leaf_size("cuda") == 128
    assert cfg.resolve_bh_leaf_size("cpu") == 256
    assert CARD_TOP >= SimConfig.AUTO_LEAF128_MAX_N


@pytest.mark.parametrize("n", [1 << 20, 1 << 21, 1 << 23])
def test_with_resolved_leaf_pins_the_card_leaf(n):
    """with_resolved_leaf: on a CUDA device the auto leaf becomes the
    card's value; on the CPU the config is returned as it is (0 resolves
    to the JAX package's rule wherever it is read); an explicit leaf is
    kept on both."""
    cfg = SimConfig(n=n)
    on_card = cfg.with_resolved_leaf("cuda")
    assert on_card.bh_leaf_size == cfg.resolve_bh_leaf_size("cuda")
    assert on_card.resolve_bh_leaf_size() == on_card.bh_leaf_size
    assert on_card.resolve_bh_refine() == cfg.resolve_bh_refine("cuda")
    assert cfg.with_resolved_leaf("cpu") is cfg
    assert cfg.with_resolved_leaf(torch.device("cpu")) is cfg
    pinned = cfg.replace(bh_leaf_size=32)
    assert pinned.with_resolved_leaf("cuda") is pinned


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_plan_and_evaluation_read_one_leaf(device, monkeypatch):
    """The entry points resolve the leaf once for the run's device:
    make_step's force function (make_accel_fn) and make_run's rebuild
    program (the plan and the frozen-list evaluation) are built from a
    config holding the same leaf, the device's, at N = 2^20 where the two
    devices' rules part."""
    cfg = SimConfig(n=1 << 20, force="barnes_hut")
    want = cfg.resolve_bh_leaf_size(device)
    seen = {}

    def fake_bh_accel(c, mass, overflow_cell=None, heal=None):
        seen["accel"] = c.resolve_bh_leaf_size()
        return lambda pos: None

    def fake_reuse(c, n_steps, report_overflow, dev, heal=None):
        seen["reuse"] = c.resolve_bh_leaf_size()
        seen["refine"] = c.resolve_bh_refine()
        return lambda state: None

    monkeypatch.setattr(bh, "make_bh_accel", fake_bh_accel)
    monkeypatch.setattr(api, "_make_run_reuse", fake_reuse)
    mass = types.SimpleNamespace(device=torch.device(device), shape=(cfg.n,))
    api.make_accel_fn(cfg, mass)
    state = types.SimpleNamespace(pos=types.SimpleNamespace(
        device=torch.device(device)))
    api.make_run(cfg, 16)(state)
    assert seen["accel"] == seen["reuse"] == want
    assert seen["refine"] == cfg.resolve_bh_refine(device)


def test_calibration_measures_at_the_resolved_leaf():
    """calibrate_budgets on the CPU keeps the auto leaf (the CPU rule) and
    measures the budgets at it; given the leaf the card would resolve, it
    measures at that leaf and returns it pinned."""
    cfg = SimConfig(n=4096, force="barnes_hut", theta=0.6)
    state = api.init_simulation(cfg, "cpu", compute_forces=False)
    cal = api.calibrate_budgets(cfg, state)
    assert cal.bh_leaf_size == 0
    pinned = cfg.with_resolved_leaf("cuda")
    cal_p = api.calibrate_budgets(pinned, state)
    assert cal_p.bh_leaf_size == pinned.bh_leaf_size == 128
    assert cal_p == api.calibrate_budgets(cfg.replace(bh_leaf_size=128),
                                          state)


def test_pinned_leaf_checkpoint_resumes_to_the_same_bits(capsys, tmp_path):
    """A config whose leaf was pinned as the card pins it (with_resolved_
    leaf), run through the CLI on the CPU: the checkpoint records the
    leaf, and a run checkpointed at step 16 and resumed to 32 equals an
    uninterrupted 32-step run bit for bit."""
    cfg = SimConfig(n=2048, force="barnes_hut", dt=0.001, theta=0.6,
                    bh_rebuild_every=8).with_resolved_leaf("cuda")
    assert cfg.bh_leaf_size == 128
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    common = ["run", "--config", str(path), "--quiet", "--log-every", "8",
              "--checkpoint-every", "16", "--device", "cpu"]
    assert tmain(common + ["--steps", "16", "--checkpoint-dir",
                           str(tmp_path / "a")]) == 0
    ck = latest_checkpoint(tmp_path / "a")
    assert json.loads(ck.with_suffix(".json").read_text())[
        "bh_leaf_size"] == 128
    assert tmain(common + ["--steps", "16", "--resume", "--checkpoint-dir",
                           str(tmp_path / "a")]) == 0
    assert tmain(common + ["--steps", "32", "--checkpoint-dir",
                           str(tmp_path / "b")]) == 0
    capsys.readouterr()
    a, cfg_a = load_checkpoint(latest_checkpoint(tmp_path / "a"),
                               device="cpu")
    b, _ = load_checkpoint(latest_checkpoint(tmp_path / "b"), device="cpu")
    assert cfg_a.bh_leaf_size == 128
    assert int(a.step) == int(b.step) == 32
    for name in ("pos", "vel", "acc", "pot", "time"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_info_reports_the_device_leaf(capsys):
    """`info` prints the config as given and, beside the resolved force,
    the leaf size a run on the named device resolves."""
    assert tmain(["info", "--n", str(1 << 20), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["config"]["bh_leaf_size"] == 0
    assert out["resolved_bh_leaf_size"] == 256
