"""The port's debug checks, renderer, metrics and profiling helpers
(utils/debug.py, render.py, metrics.py, profiling.py): the tests of
tests/test_utils.py on the CPU (the compile-cache test stays with the JAX
package's utils/cache.py, which the port drops), the renderer's images
against the JAX package's byte for byte, and the torch-only helpers."""

import json

import numpy as np
import pytest
import torch

from parallelnbody_tpu.utils import render as jrender
from parallelnbody_tpu_torch.api import init_simulation, make_step
from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.utils.debug import (StateValidationError,
                                                 check_finite, debug_nans,
                                                 validate_state)
from parallelnbody_tpu_torch.utils.io import TrajectoryWriter
from parallelnbody_tpu_torch.utils.metrics import MetricsLogger
from parallelnbody_tpu_torch.utils.profiling import force_sync, profile_trace
from parallelnbody_tpu_torch.utils.render import (export_ply, render_ppm,
                                                  render_trajectory)

torch.set_num_threads(2)

CFG = SimConfig(n=128, ic="plummer", softening=0.02, force="direct")


@pytest.fixture(scope="module")
def state():
    return init_simulation(CFG, device="cpu")


def test_validate_state_ok(state):
    validate_state(state)


def test_validate_state_catches_nan(state):
    pos = state.pos.clone()
    pos[3, 1] = torch.nan
    with pytest.raises(StateValidationError, match="non-finite"):
        validate_state(state._replace(pos=pos))


def test_debug_nans_context(state):
    """The torch counterpart checks each state handed to it; disabled, it
    lets a NaN through."""
    pos = state.pos.clone()
    pos[0, 0] = torch.inf
    bad = state._replace(pos=pos)
    with debug_nans(True) as check:
        check("ok", state)
        with pytest.raises(FloatingPointError, match="segment 2"):
            check("segment 2", bad)
    with debug_nans(False) as check:
        check("off", bad)


def test_check_finite(state):
    check_finite("t=0", state.pos, state.acc)
    with pytest.raises(FloatingPointError, match="'late'"):
        check_finite("late", state.pos, torch.tensor([1.0, torch.nan]))


def test_render_ppm(tmp_path, state):
    img = render_ppm(state.pos.numpy(), state.mass.numpy(), size=64,
                     path=tmp_path / "f.ppm")
    assert img.shape == (64, 64, 3)
    assert img.max() > 0
    data = (tmp_path / "f.ppm").read_bytes()
    assert data.startswith(b"P6 64 64 255\n")
    assert len(data) == len(b"P6 64 64 255\n") + 64 * 64 * 3
    jimg = jrender.render_ppm(state.pos.numpy(), state.mass.numpy(), size=64)
    np.testing.assert_array_equal(img, jimg)


def test_export_ply(tmp_path, state):
    p = export_ply(tmp_path / "p.ply", state.pos.numpy(), state.mass.numpy())
    lines = p.read_text().splitlines()
    assert lines[0] == "ply"
    assert f"element vertex {CFG.n}" in lines[2]
    assert len(lines) > CFG.n
    q = jrender.export_ply(tmp_path / "q.ply", state.pos.numpy(),
                           state.mass.numpy())
    assert p.read_text() == q.read_text()


def test_render_trajectory_cli(tmp_path, capsys, state):
    step = make_step(CFG)
    w = TrajectoryWriter(tmp_path / "traj", CFG)
    s = state
    for _ in range(2):
        s = step(s)
        w.append(s)
    from parallelnbody_tpu_torch.cli import main

    assert main(["render", str(tmp_path / "traj"), "--size", "32"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["frames_rendered"] == 2


def test_render_trajectory_show_tree_equals_jax(tmp_path, state):
    """Tree boxes from the port's leaf_aabbs draw the same frame as the
    JAX package's."""
    w = TrajectoryWriter(tmp_path / "traj", CFG.replace(bh_leaf_size=16))
    w.append(state)
    t = render_trajectory(tmp_path / "traj", tmp_path / "t", size=64,
                          fmt="ppm", show_tree=True, device="cpu")
    j = jrender.render_trajectory(tmp_path / "traj", tmp_path / "j", size=64,
                                  fmt="ppm", show_tree=True)
    assert t[0].read_bytes() == j[0].read_bytes()
    img = np.frombuffer(t[0].read_bytes()[len(b"P6 64 64 255\n"):], np.uint8)
    assert (img.reshape(-1, 3) == [255, 64, 64]).all(-1).any()


def test_metrics_logger(tmp_path):
    with MetricsLogger(tmp_path / "m.jsonl") as m:
        m.log({"step": 1, "energy": -0.25})
        m.log({"step": 2, "energy": torch.tensor(-0.26)})
    lines = [json.loads(line)
             for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert lines[1]["step"] == 2 and "wall_time" in lines[0]
    assert lines[1]["energy"] == pytest.approx(-0.26)


def test_force_sync(state):
    assert force_sync(state.time) == 0.0
    assert force_sync(torch.tensor([3.5, 1.0])) == 3.5


def test_profile_trace_writes_chrome_trace(tmp_path, state):
    with profile_trace(None):
        make_step(CFG)(state)
    with profile_trace(str(tmp_path / "prof")):
        make_step(CFG)(state)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
