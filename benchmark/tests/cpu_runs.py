"""Small CPU runs for the tests: the program's plain versions at sizes a
test run holds. `direct262k` is the manifest's cell with every other
setting kept; `bh.rebuild8` is a Barnes-Hut cell built here from it (the
1M configuration's physics, step(8) a call, `force_rms_err` reported), so
that the harness's Barnes-Hut path stays tested until BENCHMARK.json has a
Barnes-Hut cell again."""

import dataclasses

from benchmark import manifest
from benchmark.harness import run_cell

SEED = 2**31 + 977
BH_PHYSICS = {"force": "barnes_hut", "theta": 0.72, "bh_multipole": 2,
              "bh_leaf_size": 64, "bh_rebuild_every": 8,
              "bh_curve": "hilbert", "bh_max_levels": 12}


def cell(name):
    direct = manifest.load_cell("direct262k")
    if name == "direct262k":
        return direct
    return dataclasses.replace(
        direct, name=name, config_name="plummer-bh-small",
        config={**direct.config, **BH_PHYSICS},
        traffic_name="closed-k8",
        traffic={**direct.traffic, "steps_per_call": 8, "warmup_calls": 3,
                 "trace_calls": 2, "drawn_calls": 4},
        limits={"acc_err": 0.0025, "dx_err": 0.05, "dv_err": 0.05,
                "failed_calls": 0, "steps_off": 0},
        end_to_end=direct.end_to_end + [
            {"name": "force_rms_err", "unit": "1", "better": "lower",
             "bound": 0.01, "source": "host_clock"}],
        per_layer=[])


SMALL = {"bh.rebuild8": {"n": 2048}, "direct262k": {"n": 2048}}


def run(name, seed=SEED, seconds=0.5, **kw):
    return run_cell(cell(name), seed, seconds, device="cpu",
                    overrides=SMALL[name], **kw)
