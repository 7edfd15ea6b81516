"""The result line of a run: its keys, the metrics of the cell, and the
refusals of the command line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, manifest
from benchmark.tests import cpu_runs

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", sorted(cpu_runs.SMALL))
def test_result_line(name):
    res = cpu_runs.run(name)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = cpu_runs.cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res["checks"]) == ["acc_err", "dx_err", "dv_err",
                                   "failed_calls", "steps_off"]
    json.dumps(res)


def test_traced_result_line_keys():
    res = cpu_runs.run("direct262k", trace=True)
    # A CPU run records no device work: the per-layer metrics are left
    # out and so are busy_s and the breakdown.
    assert list(res) == KEYS + ["checks"]
    assert res["metrics"] == {}
    assert "busy_s" not in res["device"]


def test_no_card_no_result(capsys):
    if harness.torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main(["--workload", "direct262k", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_alone_in_a_directory_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark gives
    no result and a non-zero exit."""
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "direct262k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
