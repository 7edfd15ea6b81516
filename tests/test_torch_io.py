"""The port's snapshot / checkpoint / trajectory IO (utils/io.py): the tests
of tests/test_io.py on the CPU, and the files of both packages read across:
a JAX TrajectoryWriter directory through the port and the port's through
the JAX package (equal arrays, the same manifest), a JAX checkpoint into
the port (equal arrays, the seed from the checkpoint's config)."""

import json

import numpy as np
import torch

from parallelnbody_tpu import api as japi
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.utils import io as jio
from parallelnbody_tpu.utils import render as jrender
from parallelnbody_tpu_torch.api import init_simulation, make_step
from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.utils import render as trender
from parallelnbody_tpu_torch.utils.io import (
    TrajectoryWriter, latest_checkpoint, load_checkpoint, load_snapshot,
    save_checkpoint, save_snapshot)

torch.set_num_threads(2)

KW = dict(n=128, ic="plummer", dt=1e-3, softening=0.02, force="direct",
          dtype="float64")
CFG = SimConfig(**KW)
FIELDS = ("pos", "vel", "mass", "acc", "pot", "time", "step")


def test_snapshot_roundtrip(tmp_path):
    state = init_simulation(CFG, device="cpu")
    state = make_step(CFG)(state)
    p = save_snapshot(tmp_path / "s.npz", state)
    loaded = load_snapshot(p, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(state, name), getattr(loaded, name)), name
    assert loaded.seed == state.seed
    with np.load(p) as z:
        assert int(z["seed"]) == CFG.seed and "key" not in z.files


def test_checkpoint_resume_bit_identical(tmp_path):
    """Resume from a checkpoint == never stopping."""
    state = init_simulation(CFG, device="cpu")
    step = make_step(CFG)
    ref = state
    for _ in range(10):
        ref = step(ref)

    s = state
    for _ in range(5):
        s = step(s)
    save_checkpoint(tmp_path, s, CFG)
    ckpt = latest_checkpoint(tmp_path)
    assert ckpt is not None
    s2, cfg2 = load_checkpoint(ckpt, device="cpu")
    assert cfg2 == CFG
    for _ in range(5):
        s2 = step(s2)
    assert torch.equal(ref.pos, s2.pos)
    assert torch.equal(ref.vel, s2.vel)
    assert int(s2.step) == 10


def test_trajectory_writer(tmp_path):
    state = init_simulation(CFG, device="cpu")
    step = make_step(CFG)
    w = TrajectoryWriter(tmp_path / "traj", CFG)
    for _ in range(3):
        state = step(state)
        w.append(state)
    manifest = json.loads((tmp_path / "traj" / "manifest.json").read_text())
    assert len(manifest["frames"]) == 3
    assert manifest["frames"][0]["step"] == 1
    with np.load(tmp_path / "traj" / manifest["frames"][-1]["file"]) as z:
        assert z["pos"].shape == (128, 3)
        assert z["mass"].shape == (128,)


def test_trajectory_writer_appends_on_resume(tmp_path):
    """A second writer on the same dir extends the manifest instead of
    truncating it, dropping only replayed-over frames."""
    state = init_simulation(CFG, device="cpu")
    step = make_step(CFG)
    w = TrajectoryWriter(tmp_path / "traj", CFG)
    for _ in range(3):
        state = step(state)
        w.append(state)          # steps 1, 2, 3

    resumed = TrajectoryWriter(tmp_path / "traj", CFG)
    assert [f["step"] for f in resumed.frames] == [1, 2, 3]
    # Re-run from step 2: frame 3 is replayed-over and must be dropped.
    resumed.append(state._replace(step=state.step * 0 + 3))
    state4 = step(state)
    resumed.append(state4._replace(step=state4.step * 0 + 4))
    manifest = json.loads((tmp_path / "traj" / "manifest.json").read_text())
    assert [f["step"] for f in manifest["frames"]] == [1, 2, 3, 4]


def _frames(directory):
    manifest = json.loads((directory / "manifest.json").read_text())
    out = []
    for frame in manifest["frames"]:
        with np.load(directory / frame["file"]) as z:
            out.append((frame, z["pos"], z["mass"]))
    return manifest, out


def test_jax_trajectory_reads_the_same_through_the_port(tmp_path):
    """A JAX TrajectoryWriter directory: the port's renderer draws the same
    frames as the JAX package's, from the same arrays."""
    jcfg = JaxConfig(**KW)
    state = japi.init_simulation(jcfg)
    step = japi.make_step(jcfg)
    w = jio.TrajectoryWriter(tmp_path / "traj", jcfg)
    for _ in range(2):
        state = step(state)
        w.append(state)
    manifest, frames = _frames(tmp_path / "traj")
    assert manifest["config"] == json.loads(CFG.to_json())
    assert [f["step"] for f, _, _ in frames] == [1, 2]
    np.testing.assert_array_equal(frames[-1][1], np.asarray(state.pos))
    jout = jrender.render_trajectory(tmp_path / "traj", tmp_path / "j",
                                     size=32, fmt="ppm")
    tout = trender.render_trajectory(tmp_path / "traj", tmp_path / "t",
                                     size=32, fmt="ppm")
    assert [p.name for p in tout] == [p.name for p in jout]
    for a, b in zip(tout, jout):
        assert a.read_bytes() == b.read_bytes()


def test_port_trajectory_reads_the_same_through_jax(tmp_path):
    """The port's TrajectoryWriter directory has the JAX layout: the JAX
    writer resumes on it and the JAX renderer reads every frame."""
    state = init_simulation(CFG, device="cpu")
    step = make_step(CFG)
    w = TrajectoryWriter(tmp_path / "traj", CFG)
    for _ in range(2):
        state = step(state)
        w.append(state)
    manifest, frames = _frames(tmp_path / "traj")
    assert set(manifest) == {"frames", "config"}
    assert all(set(f) == {"step", "time", "file"} for f, _, _ in frames)
    np.testing.assert_array_equal(frames[-1][1], state.pos.numpy())
    np.testing.assert_array_equal(frames[-1][2], state.mass.numpy())
    assert JaxConfig(**manifest["config"]) == JaxConfig(**KW)
    resumed = jio.TrajectoryWriter(tmp_path / "traj", JaxConfig(**KW))
    assert [f["step"] for f in resumed.frames] == [1, 2]
    assert len(jrender.render_trajectory(tmp_path / "traj", size=32)) == 2


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A JAX checkpoint (raw PRNG key data in place of a seed) loads into
    the port: equal arrays, the seed from the config JSON, and the port's
    step from it equals the JAX package's direct-sum step to f64 rounding."""
    jcfg = JaxConfig(**{**KW, "seed": 7})
    state = japi.make_step(jcfg)(japi.init_simulation(jcfg))
    jio.save_checkpoint(tmp_path, state, jcfg)
    s, cfg = load_checkpoint(latest_checkpoint(tmp_path), device="cpu")
    assert cfg == SimConfig(**{**KW, "seed": 7}) and s.seed == 7
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(state, name)),
                                      err_msg=name)
    assert s.pos.dtype == torch.float64 and s.step.dtype == torch.int32
    j2 = japi.make_step(jcfg)(state)
    t2 = make_step(cfg)(s)
    np.testing.assert_allclose(t2.pos.numpy(), np.asarray(j2.pos),
                               rtol=1e-12, atol=1e-14)
