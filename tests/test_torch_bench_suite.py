"""tools/bench_suite.py on the CPU against scripts/bench_suite.py.

  * The two quick cases on the JAX package's ICs (its `init_simulation`,
    seed 0, handed to the tool through `state_from_numpy`), one timed step
    each in both: the row keys are the script's (its
    `compile_plus_first_s` named `init_plus_first_s`: the card compiles
    nothing), the overflow equals the script's `measure`, and the sampled
    rms force error agrees within 1e-6 absolute.
  * A row that raises is tabled with its error, the table is still
    written, and `main` exits non-zero; `--out` defaults under build/.
  * The sharded row runs over two CPU ranks.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from parallelnbody_tpu.api import init_simulation as jax_init
from parallelnbody_tpu_torch.state import state_from_numpy
from parallelnbody_tpu_torch.tools import bench_suite as tool

torch.set_num_threads(2)

_SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bench_suite.py"
_spec = importlib.util.spec_from_file_location("bench_suite_script", _SCRIPT)
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)   # read-only: the TPU script

CPU = torch.device("cpu")


def _jax_cfg(cfg):
    from parallelnbody_tpu.config import SimConfig as JaxConfig

    return JaxConfig.from_json(cfg.to_json())


@pytest.mark.parametrize("case", [0, 1], ids=["all-pairs", "barnes-hut"])
def test_quick_case_matches_the_script(case):
    name, cfg = tool.quick_cases()[case]
    jcfg = _jax_cfg(cfg)
    want = script.measure(jcfg, iters=1)
    ics = jax_init(jcfg, compute_forces=False)
    state = state_from_numpy({k: np.array(getattr(ics, k))
                              for k in ("pos", "vel", "mass")}, CPU)
    got = tool.measure_step(cfg, CPU, iters=1, state=state)
    renamed = {"init_plus_first_s" if k == "compile_plus_first_s" else k
               for k in want}
    assert renamed <= set(got)
    assert (got["n"], got["force"]) == (want["n"], want["force"])
    if "overflow" in want:
        assert got["overflow"] == want["overflow"] == 0
        assert got["budgets"] == want["budgets"]
        assert abs(got["rms_force_error"] - want["rms_force_error"]) < 1e-6
        assert 0 < got["rms_force_error"] < 2e-3
    else:
        assert "rms_force_error" not in got and got["pairs_per_sec"] > 0


def _fake_row(cfg, dev, **kw):
    return {"n": cfg.n, "force": cfg.resolve_force(dev), "ms_per_step": 1.0,
            "steps_per_sec": 1e3}


def test_failed_row_is_tabled_and_exits_nonzero(monkeypatch, tmp_path):
    def step(cfg, dev, **kw):
        if cfg.force == "direct":
            raise RuntimeError("no luck")
        return _fake_row(cfg, dev)

    monkeypatch.setattr(tool, "measure_step", step)
    monkeypatch.setattr(tool, "measure_reuse", _fake_row)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as err:
        tool.main(["--device", "cpu"])
    assert "all-pairs n=4096" in str(err.value)
    text = (tmp_path / tool.DEFAULT_OUT).read_text()
    assert "| all-pairs n=4096 | ERROR: RuntimeError: no luck |" in text
    assert "| BH n=16384 | 1.000 |" in text
    assert "| BH n=16384 + rebuild interval 8 (make_run) | 1.000 |" in text


def test_out_defaults_under_build(monkeypatch, tmp_path):
    monkeypatch.setattr(tool, "measure_step", _fake_row)
    monkeypatch.setattr(tool, "measure_reuse", _fake_row)
    monkeypatch.chdir(tmp_path)
    assert tool.DEFAULT_OUT.startswith("build")
    assert tool.parser().parse_args([]).out is None
    rows = tool.main(["--device", "cpu", "--quick"])
    assert [r["name"] for r in rows] == [
        "all-pairs n=4096", "BH n=16384",
        "BH n=16384 + rebuild interval 8 (make_run)"]
    assert (tmp_path / "build" / "bench_results_torch.md").is_file()
    tool.main(["--device", "cpu", "--filter", "BH", "--no-reuse"])
    assert (tmp_path / "build" / "bench_filtered_torch.md").is_file()


def test_cases_follow_the_device():
    assert [n for n, _ in tool.full_cases()] == [
        "all-pairs n=65536", "all-pairs n=262144 (BASELINE config 2)",
        "Barnes-Hut n=262144", "Barnes-Hut n=1048576 (BASELINE config 3)",
        "Barnes-Hut n=2097152 galaxy collision (BASELINE config 5)",
        "Barnes-Hut n=4194304", "Barnes-Hut n=8388608"]
    assert len(tool.full_cases(xl=True)) == 9
    for _, cfg in tool.full_cases(xl=True):
        assert cfg.bh_leaf_size == 0 and cfg.bh_near_budget == 0
        assert cfg.bh_far_budget == 0 and cfg.bh_cand_budget == 0


def test_sharded_row_over_two_ranks():
    cfg = tool.SimConfig(n=1024, force="direct", track_potential=False,
                         **tool.COMMON)
    row = tool.measure_sharded(cfg, 2, CPU, iters=1)
    assert row["devices"] == 2 and row["force"] == "direct"
    assert row["ms_per_step"] > 0 and row["pairs_per_sec_per_device"] > 0
