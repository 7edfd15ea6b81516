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
    for const in ("AUTO_BH_CROSSOVER", "FALLBACK_NEAR_BUDGET",
                  "FALLBACK_FAR_BUDGET"):
        assert getattr(TorchConfig, const) == getattr(JaxConfig, const)


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
    code = ("import sys, parallelnbody_tpu_torch, parallelnbody_tpu_torch.api,"
            " parallelnbody_tpu_torch.ops.bh, parallelnbody_tpu_torch.ops"
            ".direct_kernels, parallelnbody_tpu_torch.kernels.build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'parallelnbody_tpu' or "
            "m.startswith('parallelnbody_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
