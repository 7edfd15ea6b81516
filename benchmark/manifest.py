"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`) and traffic mix (`traffic/<traffic>.json`) and
holds its comparison's sample size and limits; a per-layer metric is
`metrics/<name>.py`. BENCHMARK.json says which metrics each cell reports. Adding a cell, a configuration, a
traffic mix or a metric is adding files and entries: no code here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict        # the configuration file, as written
    traffic_name: str
    traffic: dict       # the traffic file
    chips: int
    targets: int        # the judged calls' sampled targets (check.py)
    limits: dict        # {number: limit} of check.py
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list


def _read(path):
    with open(path) as f:
        return json.load(f)


def load_manifest(path=MANIFEST):
    return _read(path)


def reports(entry, cell_name, cell_e2e):
    """True where the metric `entry` is reported in the cell: the cells
    its `workloads` list, or, without that key, every cell (end to end)
    or every cell that reports the metric it moves (per layer)."""
    if "workloads" in entry:
        return cell_name in entry["workloads"]
    return "moves" not in entry or entry["moves"] in cell_e2e


def load_cell(name, manifest=None, bench_dir=BENCH_DIR):
    """The Cell named `name` in BENCHMARK.json with its files. Raises
    KeyError for a cell the manifest lacks and ValueError where the cell's
    file and the manifest's entry disagree."""
    manifest = load_manifest() if manifest is None else manifest
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    entry = entries[name]
    work = _read(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips", "why"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {work[key]!r} in its "
                             f"workload file, {entry[key]!r} in "
                             "BENCHMARK.json")
    e2e = [m for m in manifest["end_to_end"] if reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(
        name=name, config_name=entry["config"],
        config=_read(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic_name=entry["traffic"],
        traffic=_read(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        chips=entry["chips"], targets=work["targets"],
        limits=work["limits"], end_to_end=e2e,
        per_layer=per_layer)


def load_metric(name, bench_dir=BENCH_DIR):
    """The module metrics/<name>.py: its NAME, UNIT, BETTER, LAYER, MOVES,
    SOURCE and read(trace) -> float or None."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
