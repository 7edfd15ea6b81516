"""BENCHMARK.json and every file it names: they load, keep to the
contract's names, units and keys, and a cell, configuration, traffic mix
or metric is added as new files alone."""

import json
import shutil

import pytest

from benchmark import manifest

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(M) == TOP_KEYS
    for section, keys in KEYS.items():
        for entry in M[section]:
            assert set(entry) - {"workloads"} == keys, entry
            if "workloads" in entry:
                assert section in ("end_to_end", "per_layer")


def test_names_units_and_lines():
    names = [e["name"] for s in KEYS for e in M[s]]
    for section in KEYS:
        got = [e["name"] for e in M[section]]
        assert len(got) == len(set(got)), section
    for name in names:
        assert manifest.NAME_RE.match(name), name
    for entry in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT_RE.match(entry["unit"]), entry
        assert entry["better"] in ("lower", "higher")
    for entry in M["configs"]:
        assert _line(entry["source"]) and _line(entry["why"])
        assert len(entry["reduced"]) <= 16
        for key in entry["reduced"]:
            assert manifest.NAME_RE.match(key)
    for entry in M["workloads"]:
        assert _line(entry["why"])
        assert entry["chips"] in (1, 4)
        assert manifest.NAME_RE.match(entry["config"])
        assert manifest.NAME_RE.match(entry["traffic"])
    for entry in M["per_layer"]:
        assert _line(entry["layer"])
    for word in M["command"]:
        assert _line(word)
    assert len(json.dumps(M)) <= 64 * 1024


def test_command_paths_and_window():
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for path in manifest.ROOT.joinpath("benchmark").rglob("*"):
        rel = path.relative_to(manifest.ROOT).as_posix()
        if "__pycache__" not in rel:
            assert all(manifest.NAME_RE.match(part)
                       for part in rel.split("/")), rel


def test_bounds():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_files(name):
    cell = manifest.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert cell.config["source"] == next(
        c["source"] for c in M["configs"] if c["name"] == cell.config_name)
    assert cell.traffic["steps_per_call"] >= 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for number in ("acc_err", "dx_err", "dv_err", "failed_calls",
                   "steps_off"):
        assert number in cell.limits
    assert cell.targets >= 1


def test_every_config_used_and_under_paths():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.loads(manifest.ROOT.joinpath(c["file"]).read_text())
        assert data["reduced"] == c["reduced"]


@pytest.mark.parametrize("entry", M["per_layer"], ids=lambda e: e["name"])
def test_metric_file_matches_its_entry(entry):
    mod = manifest.load_metric(entry["name"])
    assert mod.NAME == entry["name"]
    assert mod.UNIT == entry["unit"]
    assert mod.BETTER == entry["better"]
    assert mod.LAYER == entry["layer"]
    assert mod.MOVES == entry["moves"]
    assert mod.SOURCE == entry["source"]
    assert callable(mod.read)


@pytest.mark.parametrize("entry", M["per_layer"], ids=lambda e: e["name"])
def test_metric_cells_report_what_it_moves(entry):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    moved = e2e[entry["moves"]]
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)
        assert entry["name"] in {m["name"] for m in
                                 manifest.load_cell(cell).per_layer}


def test_end_to_end_cells_exist():
    for m in M["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_a_cell_is_added_as_files(tmp_path):
    """A new configuration, traffic mix, cell and metric: new files and
    manifest entries, no edit to an existing file."""
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "plummer-262k-direct.json")
                     .read_text())
    cfg.update(name="plummer-8m-bh", n=8388608, force="barnes_hut",
               theta=0.72, bh_multipole=2)
    (bench / "configs" / "plummer-8m-bh.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "closed-k4.json").write_text(json.dumps(
        {"loop": "closed", "callers": 1, "steps_per_call": 4,
         "warmup_calls": 2, "trace_calls": 1}))
    cell = {"config": "plummer-8m-bh", "traffic": "closed-k4", "chips": 1,
            "why": "a later cell", "targets": 512, "limits": {
                "acc_err": 3e-3, "dx_err": 1e-2,
                "dv_err": 1e-2, "failed_calls": 0, "steps_off": 0}}
    (bench / "workloads" / "bh8m.k4.json").write_text(json.dumps(cell))
    (bench / "metrics" / "k1_calls.py").write_text(
        'NAME = "k1_calls"\nUNIT = "1/step"\nBETTER = "lower"\n'
        'LAYER = "K1 near field"\nMOVES = "step_ms"\n'
        'SOURCE = "device_trace"\n\n\ndef read(trace):\n    return 1.0\n')
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "plummer-8m-bh", "source": "s",
                         "file": "benchmark/configs/plummer-8m-bh.json",
                         "reduced": [], "why": "w"})
    m["workloads"].append({"name": "bh8m.k4", **{k: cell[k] for k in (
        "config", "traffic", "chips", "why")}})
    for entry in m["end_to_end"] + m["per_layer"]:
        if "workloads" in entry and entry["name"] not in ("k3_roofline",
                                                         "step_mfu"):
            entry["workloads"].append("bh8m.k4")
    m["per_layer"].append({"name": "k1_calls", "unit": "1/step",
                           "better": "lower", "source": "device_trace",
                           "layer": "K1 near field", "moves": "step_ms"})
    got = manifest.load_cell("bh8m.k4", manifest=m, bench_dir=bench)
    assert got.config["n"] == 8388608
    assert got.traffic["steps_per_call"] == 4
    names = {e["name"] for e in got.per_layer}
    assert "k1_calls" in names and "k3_roofline" not in names
    assert "k1_calls" in {e["name"] for e in manifest.load_cell(
        "direct262k", manifest=m, bench_dir=bench).per_layer}
    assert manifest.load_metric("k1_calls", bench_dir=bench).read(None) == 1
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())


def test_cell_file_must_agree_with_manifest(tmp_path):
    m = json.loads(json.dumps(M))
    m["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError):
        manifest.load_cell(m["workloads"][0]["name"], manifest=m)
    with pytest.raises(KeyError):
        manifest.load_cell("no-such-cell")
