"""The port's SimConfig against the JAX package's: same fields, defaults,
validation errors and resolvers; every example config loads in both; the
port never imports JAX."""

import dataclasses
import glob
import os
import subprocess
import sys

import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu_torch.config import SimConfig as TorchConfig

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.json")))


def test_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TorchConfig)]
    assert tf == jf
    # The CPU crossover and the static budgets are the JAX package's; the
    # card's crossover is its own sweep's (config.py, PERF.md).
    for const in ("AUTO_BH_CROSSOVER", "FALLBACK_NEAR_BUDGET",
                  "FALLBACK_FAR_BUDGET"):
        assert getattr(TorchConfig, const) == getattr(JaxConfig, const)
    assert TorchConfig.AUTO_BH_CROSSOVER_CUDA == 196608
    assert TorchConfig().bh_crossover("cuda:0") == 196608
    assert TorchConfig().bh_crossover(None) == JaxConfig.AUTO_BH_CROSSOVER


@pytest.mark.parametrize("bad", [
    {"force": "fmm"}, {"integrator": "verlet9"}, {"ic": "torus"},
    {"bh_refine": "block"}, {"bh_far_mode": "lists"}, {"bh_comm": "tree"},
    {"bh_import_budget": -1}, {"bh_pair_slack": 0.0}, {"bh_own_slack": -1.0},
    {"bh_cand_budget": -1}, {"bh_rebuild_every": 0}, {"bh_sections": -2},
    {"n": 0}, {"dt": 0.0},
], ids=lambda d: next(iter(d)))
def test_validation_errors_equal(bad):
    with pytest.raises(ValueError) as ej:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as et:
        TorchConfig(**bad)
    assert str(et.value) == str(ej.value)


def test_examples_present():
    assert len(EXAMPLES) == 10


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_loads_in_both(path):
    text = open(path).read()
    jc, tc = JaxConfig.from_json(text), TorchConfig.from_json(text)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.resolve_bh_leaf_size() == jc.resolve_bh_leaf_size()
    assert tc.resolve_bh_refine() == jc.resolve_bh_refine()
    assert tc.resolve_bh_near_budget() == jc.resolve_bh_near_budget()
    assert tc.resolve_bh_far_budget() == jc.resolve_bh_far_budget()
    # Tests run the JAX package on the CPU, where its auto never picks
    # the Pallas all-pairs kernel: both resolve alike.
    assert tc.resolve_force() == jc.resolve_force("cpu")
    # On the accelerator both pick their all-pairs kernel below the
    # crossover (K3 in the port, the Pallas kernel in the JAX package).
    assert tc.resolve_force("cuda") == jc.resolve_force("tpu")
    assert TorchConfig.from_json(tc.to_json()) == tc


def test_import_leaves_jax_out():
    """Every module of the port (all but __main__, which runs the CLI)
    imports without JAX or the JAX package."""
    code = ("import importlib, pkgutil, sys, parallelnbody_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'parallelnbody_tpu_torch.') if not m.name.endswith('__main__')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert 'parallelnbody_tpu_torch.cli' in mods, mods; "
            "assert 'parallelnbody_tpu_torch.parallel.distributed' in "
            "sys.modules, mods; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'parallelnbody_tpu' or "
            "m.startswith('parallelnbody_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_all_covers_the_jax_package():
    import parallelnbody_tpu
    import parallelnbody_tpu_torch

    assert set(parallelnbody_tpu.__all__) <= set(parallelnbody_tpu_torch.__all__)
    for name in parallelnbody_tpu_torch.__all__:
        assert hasattr(parallelnbody_tpu_torch, name), name
    from parallelnbody_tpu_torch import (calibrate_budgets,  # noqa: F401
                                         init_simulation,
                                         reference_compat_config)
    import parallelnbody_tpu.parallel as jpar
    import parallelnbody_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in tpar.__all__:
        assert hasattr(tpar, name), name


def test_make_run_and_make_step_resolve_alike_on_the_card():
    """At N = 65536 force="auto" is K3 on a CUDA device (below the card's
    crossover) and Barnes-Hut on the CPU (the JAX package's crossover): the
    reuse-program check of make_run and the force function of make_step
    agree on each device. No card needed: the device is only a name here,
    and make_accel_fn builds its closure without touching the tensor."""
    import types

    from parallelnbody_tpu_torch import api

    cfg = TorchConfig(n=65536)
    for device, method in (("cuda", "direct_pallas"), ("cpu", "barnes_hut")):
        assert cfg.resolve_force(device) == method
        assert api._reuse_eligible(cfg, 16, device) == (method == "barnes_hut")
        mass = types.SimpleNamespace(device=torch.device(device),
                                     shape=(cfg.n,))
        fn = api.make_accel_fn(cfg, mass)
        maker = ("make_allpairs_accel" if method == "direct_pallas"
                 else "make_bh_accel")
        assert fn.__qualname__.startswith(maker), fn.__qualname__


def test_plan_ratio_by_device():
    """The rebuild-block cost model takes the JAX package's plan/eval ratio
    on the CPU and the card's on a CUDA device."""
    from parallelnbody_tpu import api as japi
    from parallelnbody_tpu_torch import api

    assert api._plan_ratio("cpu") == japi._REUSE_PLAN_RATIO
    assert api._plan_ratio("cuda:0") == api._REUSE_PLAN_RATIO["cuda"]
    for n_steps in range(2, 40):
        assert api._reuse_block_size(8, n_steps) == \
            japi._reuse_block_size(8, n_steps)
    # The run length at which the card's block size was timed against the
    # CPU ratio's (tools/auto_rules.py block): the two ratios part there.
    assert api._reuse_block_size(8, 33, api._plan_ratio("cpu")) == 3
    assert api._reuse_block_size(8, 33, api._plan_ratio("cuda")) == 7
