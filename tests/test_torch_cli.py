"""The port's command line (parallelnbody_tpu_torch/cli.py, in process via
cli.main with --device cpu): the single-device tests of tests/test_cli.py,
the same commands against the JAX package's CLI at the same flags (`run`
resumed by both from one JAX checkpoint to equal states and energies,
tree statistics, trajectory manifests of the same shape), and the
multi-device requests (--devices, --distributed, a mesh config) on CPU
ranks against the JAX CLI at the same flags."""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from parallelnbody_tpu.cli import main as jmain
from parallelnbody_tpu_torch.cli import main as tmain
from parallelnbody_tpu_torch.utils.io import latest_checkpoint, load_checkpoint

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def main(argv):
    """The port's CLI on the CPU: --device cpu after the subcommand (and
    after the trajectory directory of `render`)."""
    return tmain(argv + CPU)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _png(path, size):
    """(size, size, 3) pixels of a PNG the renderer wrote (one IDAT,
    filter 0)."""
    raw = path.read_bytes()
    i = raw.index(b"IDAT") + 4
    ln = struct.unpack(">I", raw[i - 8:i - 4])[0]
    data = zlib.decompress(raw[i:i + ln])
    img = np.frombuffer(data, np.uint8).reshape(size, size * 3 + 1)[:, 1:]
    return img.reshape(size, size, 3)


def test_info(capsys):
    assert main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["backend"] == "cpu" and out["devices"] == ["cpu"]
    assert out["version"] == "0.1.0"
    assert "config" in out


def test_run_plummer(capsys, tmp_path):
    rc = main([
        "run", "--n", "256", "--steps", "20", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--log-every", "10",
        "--metrics", str(tmp_path / "m.jsonl"), "--quiet",
        "--snapshot-every", "10", "--snapshot-dir", str(tmp_path / "snaps"),
    ])
    assert rc == 0
    summary = _last_json(capsys)
    assert summary["steps"] == 20
    assert abs(summary["energy_drift"]) < 1e-3
    lines = (tmp_path / "m.jsonl").read_text().strip().splitlines()
    assert len(lines) >= 2
    assert (tmp_path / "snaps" / "manifest.json").exists()


def test_run_compat_profile(capsys):
    rc = main(["run", "--compat", "--n", "64", "--steps", "5", "--quiet"])
    assert rc == 0
    assert _last_json(capsys)["steps"] == 5


def test_run_checkpoint_resume(capsys, tmp_path):
    common = [
        "run", "--n", "128", "--steps", "10", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--checkpoint-every", "5", "--checkpoint-dir", str(tmp_path / "ck"),
        "--dtype", "float64",
    ]
    assert main(common) == 0
    capsys.readouterr()
    # Resume: picks up at step 10, runs 10 more
    assert main(common + ["--resume"]) == 0
    capsys.readouterr()
    state, _cfg = load_checkpoint(latest_checkpoint(tmp_path / "ck"),
                                  device="cpu")
    assert int(state.step) == 20


def test_resume_bit_identical_to_uninterrupted(capsys, tmp_path):
    """A Barnes-Hut run at rebuild 8 checkpointed at step 16 and resumed
    to 32 equals an uninterrupted 32-step run at the same cadences."""
    common = ["run", "--n", "2048", "--force", "barnes_hut",
              "--bh-leaf-size", "32", "--dt", "0.001", "--quiet",
              "--log-every", "8", "--checkpoint-every", "16"]
    assert main(common + ["--steps", "16", "--checkpoint-dir",
                          str(tmp_path / "a")]) == 0
    assert main(common + ["--steps", "16", "--resume", "--checkpoint-dir",
                          str(tmp_path / "a")]) == 0
    assert main(common + ["--steps", "32", "--checkpoint-dir",
                          str(tmp_path / "b")]) == 0
    capsys.readouterr()
    a, _ = load_checkpoint(latest_checkpoint(tmp_path / "a"), device="cpu")
    b, _ = load_checkpoint(latest_checkpoint(tmp_path / "b"), device="cpu")
    assert int(a.step) == int(b.step) == 32
    for name in ("pos", "vel", "acc", "pot", "time"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_resume_cli_overrides_win(capsys, tmp_path):
    """Explicit CLI flags override the checkpointed config on --resume."""
    common = [
        "run", "--n", "128", "--steps", "4", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--checkpoint-every", "4", "--checkpoint-dir", str(tmp_path / "ck"),
    ]
    assert main(common) == 0
    assert main(common + ["--resume", "--steps", "6", "--dt", "0.002"]) == 0
    capsys.readouterr()
    state, cfg = load_checkpoint(latest_checkpoint(tmp_path / "ck"),
                                 device="cpu")
    assert cfg.dt == 0.002          # CLI override survived the resume
    assert cfg.steps == 6


def test_run_control_dt_change(capsys, tmp_path):
    """The control file changes dt: placed before the run, it applies from
    the first segment, so final time = steps * new_dt."""
    ctl = tmp_path / "ctl.json"
    ctl.write_text(json.dumps({"dt": 0.002}))
    rc = main([
        "run", "--n", "64", "--steps", "6", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--log-every", "2", "--control", str(ctl),
        "--checkpoint-every", "6", "--checkpoint-dir", str(tmp_path / "ck"),
    ])
    assert rc == 0
    capsys.readouterr()
    state, cfg = load_checkpoint(latest_checkpoint(tmp_path / "ck"),
                                 device="cpu")
    assert cfg.dt == 0.002
    assert abs(float(state.time) - 6 * 0.002) < 1e-6  # f32 time accumulation


def test_run_control_stop(capsys, tmp_path):
    """control {'stop': true} halts after the next poll with a checkpoint."""
    ctl = tmp_path / "ctl.json"
    ctl.write_text(json.dumps({"stop": True}))
    rc = main([
        "run", "--n", "64", "--steps", "50", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--log-every", "5", "--control", str(ctl),
        "--checkpoint-dir", str(tmp_path / "ck"),
    ])
    assert rc == 0
    assert _last_json(capsys)["steps"] == 0   # stopped before the first segment
    assert latest_checkpoint(tmp_path / "ck") is not None


def test_tree_stats_cmd(capsys):
    """`tree` dumps depth/level widths/list-length stats."""
    rc = main(["tree", "--n", "2048", "--ic", "plummer",
               "--bh-leaf-size", "32", "--theta", "0.5"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n"] == 2048
    assert out["n_leaves"] == 64
    assert out["level_widths"][0] == 64 and out["level_widths"][-1] == 1
    assert out["overflow"] == 0
    assert out["near_leaves_per_target"]["max"] >= 1


def test_tree_stats_staged(capsys):
    """`tree` audits whichever refinement mode the config resolves to."""
    rc = main(["tree", "--n", "16384", "--ic", "plummer",
               "--bh-leaf-size", "32", "--theta", "0.5",
               "--bh-refine", "staged"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["refine"] == "staged"
    assert out["overflow"] == 0
    assert out["far_octets_per_target"]["max"] >= 1
    assert out["cand_budgets"]["cand1"] > 0


def test_render_show_tree(capsys, tmp_path):
    """--show-tree overlays leaf boxes (red pixels appear in the frame)."""
    rc = main([
        "run", "--n", "256", "--steps", "4", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--bh-leaf-size", "16",
        "--snapshot-every", "4", "--snapshot-dir", str(tmp_path / "t"),
    ])
    assert rc == 0
    capsys.readouterr()
    rc = main(["render", str(tmp_path / "t"), "--size", "128",
               "--show-tree", "--fmt", "ppm"])
    assert rc == 0
    out = _last_json(capsys)
    assert out["frames_rendered"] == 1 and out["show_tree"]
    frame = next((tmp_path / "t" / "frames").glob("*.ppm"))
    data = frame.read_bytes()
    img = np.frombuffer(data[data.index(b"255\n") + 4:], np.uint8)
    img = img.reshape(128, 128, 3).astype(int)
    # Box outlines are pure (255, 64, 64): strongly red pixels must exist.
    assert int(((img[..., 0] == 255) & (img[..., 1] == 64)).sum()) > 50


def test_auto_bh_leaf_size():
    from parallelnbody_tpu_torch.config import SimConfig

    assert SimConfig(n=262144).resolve_bh_leaf_size() == 128
    assert SimConfig(n=1048576).resolve_bh_leaf_size() == 256
    assert SimConfig(n=4194304).resolve_bh_leaf_size() == 256
    assert SimConfig(n=4194304).resolve_bh_refine() == "staged"
    assert SimConfig(n=1048576).resolve_bh_refine() == "dense"
    assert SimConfig(n=4096, bh_leaf_size=32).resolve_bh_leaf_size() == 32


def test_auto_force_crossover():
    """force='auto' is scale-aware, by device: the JAX package's crossover
    on the CPU, the card's on a CUDA device, K3 on the card from N = 512."""
    from parallelnbody_tpu_torch.config import SimConfig

    assert SimConfig(n=1024).resolve_force("cpu") == "direct"
    assert SimConfig(n=1024).resolve_force("cuda") == "direct_pallas"
    assert SimConfig(n=256).resolve_force("cuda") == "direct"
    big = SimConfig(n=SimConfig.AUTO_BH_CROSSOVER)
    assert big.resolve_force("cpu") == "barnes_hut"
    assert big.resolve_force("cuda") == "direct_pallas"
    card = SimConfig(n=SimConfig.AUTO_BH_CROSSOVER_CUDA)
    assert card.resolve_force("cuda") == "barnes_hut"
    assert card.replace(n=card.n - 1).resolve_force("cuda") == "direct_pallas"


def test_bench_cmd(capsys):
    rc = main(["bench", "--n", "512", "--force", "direct", "--iters", "2",
               "--softening", "0.02"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps_per_sec"] > 0 and out["device"] == "cpu"


def test_bench_run_steps_reuse(capsys):
    """bench --run-steps times the fused make_run, including the
    tree-rebuild-interval program when bh_rebuild_every routes there."""
    rc = main(["bench", "--n", "2048", "--force", "barnes_hut",
               "--bh-leaf-size", "32", "--theta", "0.72", "--iters", "1",
               "--softening", "0.02", "--run-steps", "4",
               "--bh-rebuild-every", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["run_steps"] == 4
    assert out["bh_rebuild_every"] == 2
    assert out["overflow"] == 0
    assert out["steps_per_sec"] > 0


def test_oracle_cmd(capsys):
    rc = main(["oracle", "--n", "128", "--steps", "100", "--dt", "0.001",
               "--softening", "0.05", "--force", "direct", "--trajectory"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out
    assert out["pass"] is True
    assert out["trajectory_rel_err"] < 0.01


def test_run_render_every(capsys, tmp_path):
    """--render-every emits frames during the run: one at step 0 plus one
    per cadence boundary."""
    rc = main([
        "run", "--n", "64", "--steps", "4", "--dt", "0.001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--render-every", "2", "--render-dir", str(tmp_path / "fr"),
        "--render-size", "64",
    ])
    assert rc == 0
    capsys.readouterr()
    frames = sorted(p.name for p in (tmp_path / "fr").glob("frame_*.png"))
    assert frames == ["frame_000000.png", "frame_000002.png",
                      "frame_000004.png"]


def test_run_control_changes_live_view(capsys, tmp_path):
    """A control-file render_extent takes effect on frames rendered after
    the poll: zooming far out concentrates the lit pixels in the center."""
    ctl = tmp_path / "ctl.json"
    ctl.write_text(json.dumps({"render_extent": 100.0}))
    rc = main([
        "run", "--n", "256", "--steps", "4", "--dt", "0.0001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--render-every", "2", "--render-dir", str(tmp_path / "fr"),
        "--render-size", "64", "--control", str(ctl), "--log-every", "2",
    ])
    assert rc == 0
    capsys.readouterr()

    def lit_outside_center(name):
        lit = _png(tmp_path / "fr" / name, 64).sum(-1) > 0
        return lit.sum() - lit[24:40, 24:40].sum(), lit.sum()

    out0, tot0 = lit_outside_center("frame_000000.png")
    out2, tot2 = lit_outside_center("frame_000002.png")
    assert tot0 > 0 and tot2 > 0
    assert out0 > 0
    assert out2 == 0, (out2, tot2)


def test_run_live_show_tree(capsys, tmp_path):
    """--show-tree overlays leaf boxes on live frames: the exact overlay
    color (255, 64, 64) cannot come from the renderer's colormap."""
    rc = main([
        "run", "--n", "256", "--steps", "2", "--dt", "0.0001",
        "--softening", "0.02", "--force", "direct", "--quiet",
        "--render-every", "2", "--render-dir", str(tmp_path / "fr"),
        "--render-size", "64", "--show-tree", "--bh-leaf-size", "32",
    ])
    assert rc == 0
    capsys.readouterr()
    img = _png(tmp_path / "fr" / "frame_000002.png", 64)
    assert (img == np.array([255, 64, 64], np.uint8)).all(-1).any()


MULTI_FLAGS = ["--n", "256", "--dt", "0.001", "--softening", "0.02",
               "--force", "direct", "--quiet", "--log-every", "0"]


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _distributed_run(argv, world_size, tmp_path):
    """The port's CLI as world_size processes started the way torchrun
    starts them (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), --device cpu;
    returns rank 0's standard output."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    port = str(_free_port())
    procs = []
    for rank in range(world_size):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world_size),
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "parallelnbody_tpu_torch", *argv,
             "--distributed", *CPU], cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs[0][0]


@pytest.mark.parametrize("case", ["devices", "devices-dcn", "distributed",
                                  "mesh-config", "overflowed-segment"])
def test_multi_device_requests_run(case, capsys, tmp_path):
    """The multi-device requests run on CPU ranks and match the JAX CLI at
    the same flags (the JAX package on its 8 virtual CPU devices): `run
    --devices 8` and `run --distributed` (two torchrun-style processes,
    against the JAX CLI's `--devices 2`) resumed by both from one JAX
    checkpoint to the same summary keys and final states; `bench --devices
    4x2` timing the 8-rank sharded step; `info` on the 4-device all-pairs
    example; a distributed Barnes-Hut segment that overflows (near budget
    2), which both discard and redo step by step, to the same overflow
    count and state."""
    import shutil

    if case == "devices-dcn":
        argv = ["bench", "--n", "256", "--force", "direct", "--devices",
                "4x2", "--iters", "1"]
        assert jmain(argv) == 0
        j = _last_json(capsys)
        assert main(argv) == 0
        t = _last_json(capsys)
        assert set(j) <= set(t)
        assert t["devices"] == j["devices"] == 8
        assert (t["n"], t["force"]) == (j["n"], j["force"])
        assert t["ms_per_step"] > 0
        return
    if case == "mesh-config":
        argv = ["info", "--config", "examples/allpairs_4m_mesh.json"]
        assert jmain(argv) == 0
        j = json.loads(capsys.readouterr().out)
        assert main(argv) == 0
        t = json.loads(capsys.readouterr().out)
        assert t["config"] == j["config"]
        assert t["config"]["mesh_shape"] == [4]
        assert t["resolved_force"] == j["resolved_force"]
        return

    assert jmain(["run", *MULTI_FLAGS, "--steps", "2", "--checkpoint-every",
                  "2", "--checkpoint-dir", str(tmp_path / "c0")]) == 0
    for pkg in ("j", "t"):
        shutil.copytree(tmp_path / "c0", tmp_path / f"c{pkg}")
    capsys.readouterr()
    n_dev = "8" if case == "devices" else "2"
    resume = ["run", *MULTI_FLAGS, "--steps", "2", "--checkpoint-every", "2",
              "--resume"]
    if case == "overflowed-segment":
        resume += ["--force", "barnes_hut", "--bh-distributed", "true",
                   "--bh-leaf-size", "16", "--bh-near-budget", "2"]
    assert jmain([*resume, "--devices", n_dev, "--checkpoint-dir",
                  str(tmp_path / "cj")]) == 0
    j = _last_json(capsys)
    if case != "distributed":
        assert main([*resume, "--devices", n_dev, "--checkpoint-dir",
                     str(tmp_path / "ct")]) == 0
        t = _last_json(capsys)
    else:
        out = _distributed_run([*resume, "--checkpoint-dir",
                                str(tmp_path / "ct")], 2, tmp_path)
        t = json.loads(out.strip().splitlines()[-1])
    assert set(t) == set(j)
    for key in ("steps", "n", "force", "interrupted", "bh_overflow"):
        assert t[key] == j[key], key
    assert (t["bh_overflow"] > 0) == (case == "overflowed-segment")
    sj, _ = load_checkpoint(latest_checkpoint(tmp_path / "cj"), device="cpu")
    st, _ = load_checkpoint(latest_checkpoint(tmp_path / "ct"), device="cpu")
    assert int(sj.step) == int(st.step) == 4
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   getattr(sj, name).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for key in ("energy_drift", "momentum_norm"):
        np.testing.assert_allclose(t[key], j[key], atol=1e-6, err_msg=key)


def test_run_without_card_raises():
    """--device defaults to the card; without one the command raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain(["run", "--n", "64", "--steps", "1", "--force", "direct"])


# ----------------------------------------------------------- against the JAX CLI
RUN_FLAGS = ["--n", "512", "--steps", "40", "--dt", "0.001",
             "--softening", "0.02", "--log-every", "20", "--quiet",
             "--snapshot-every", "20"]


@pytest.mark.parametrize("force", ["direct", "barnes_hut"])
def test_run_matches_jax_cli(force, capsys, tmp_path):
    """`run` at the same flags in both packages, from the same state: a
    JAX checkpoint that each package resumes. The same summary keys,
    steps and force; final positions, velocities and energies equal to
    f32 rounding; trajectory manifests of the same shape and config."""
    import shutil

    extra = ["--force", force, "--bh-leaf-size", "32",
             "--checkpoint-every", "40"]
    assert jmain(["run", *RUN_FLAGS, *extra, "--checkpoint-dir",
                  str(tmp_path / "c0")]) == 0
    for pkg in ("j", "t"):
        shutil.copytree(tmp_path / "c0", tmp_path / f"c{pkg}")
    capsys.readouterr()
    resume = ["run", *RUN_FLAGS, *extra, "--resume"]
    assert jmain([*resume, "--checkpoint-dir", str(tmp_path / "cj"),
                  "--snapshot-dir", str(tmp_path / "j")]) == 0
    j = _last_json(capsys)
    assert main([*resume, "--checkpoint-dir", str(tmp_path / "ct"),
                 "--snapshot-dir", str(tmp_path / "t")]) == 0
    t = _last_json(capsys)
    assert set(t) == set(j)
    for key in ("steps", "n", "force", "interrupted", "bh_overflow"):
        assert t[key] == j[key], key
    assert t["steps"] == 40
    sj, _ = load_checkpoint(latest_checkpoint(tmp_path / "cj"), device="cpu")
    st, _ = load_checkpoint(latest_checkpoint(tmp_path / "ct"), device="cpu")
    assert int(sj.step) == int(st.step) == 80
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   getattr(sj, name).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for key in ("energy_drift", "momentum_norm"):
        np.testing.assert_allclose(t[key], j[key], atol=1e-6, err_msg=key)
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "manifest.json").read_text())
    dirs = {"snapshot_dir": "", "checkpoint_dir": ""}
    assert {**mt["config"], **dirs} == {**mj["config"], **dirs}
    assert [(f["step"], f["file"]) for f in mt["frames"]] == \
        [(f["step"], f["file"]) for f in mj["frames"]]
    np.testing.assert_allclose([f["time"] for f in mt["frames"]],
                               [f["time"] for f in mj["frames"]], rtol=1e-6)


@pytest.mark.parametrize("refine", ["dense", "staged"])
def test_tree_matches_jax_cli(refine, capsys):
    """`tree` at the same flags: the same structure, list statistics and
    overflow (the ICs differ in their draws, so the positions are each
    package's own; the counts are compared where they are fixed by N and
    the budgets, the statistics to 20%)."""
    flags = ["tree", "--n", "8192", "--ic", "plummer", "--bh-leaf-size", "32",
             "--theta", "0.5", "--bh-refine", refine, "--force", "barnes_hut"]
    assert jmain(flags) == 0
    j = json.loads(capsys.readouterr().out)
    assert main(flags) == 0
    t = json.loads(capsys.readouterr().out)
    assert set(t) == set(j)
    for key in ("n", "n_leaves", "leaf_size", "levels", "level_widths",
                "theta", "curve", "refine", "far_mode", "budgets",
                "overflow"):
        assert t[key] == j[key], key
    assert set(t["requirements"]) == set(j["requirements"])
    for stat in ("near_leaves_per_target", "far_octets_per_target"):
        assert t[stat]["mean"] == pytest.approx(j[stat]["mean"], rel=0.2)


def test_run_heals_clipping_auto_budgets(capsys, tmp_path, monkeypatch):
    """A run whose calibrated budgets clip from its first step (cut to 4
    after calibration): the step programs grow them (ops/bh.py ListHeal)
    before any force is taken from the clipped lists, so no segment
    reports an overflow, which alone set off the CLI's old mid-run
    recalibration, and the run ends bit for bit where a run at budgets
    that clip nothing ends. The budgets the heal grew to are the ones a
    recalibration on the final state gives: it would grow nothing."""
    from parallelnbody_tpu_torch import SimConfig, api
    from parallelnbody_tpu_torch.kernels.launch import COUNTERS
    from parallelnbody_tpu_torch.ops.bh import BUDGET_FIELDS, ListHeal
    from parallelnbody_tpu_torch.tools.auto_rules import \
        recalibrate_on_overflow

    prepare = api.prepare_simulation
    cut = {"bh_near_budget": 4, "bh_far_budget": 4}
    monkeypatch.setattr(api, "prepare_simulation", lambda *a, **k: (
        lambda cal, state: (cal.calibrated(**cut), state))(*prepare(*a, **k)))
    common = ["run", "--n", "4096", "--force", "barnes_hut",
              "--bh-leaf-size", "16", "--theta", "0.72", "--bh-multipole",
              "2", "--dt", "0.001", "--steps", "16", "--log-every", "8",
              "--checkpoint-every", "16"]
    heals = COUNTERS["bh.heals"]
    assert main(common + ["--metrics", str(tmp_path / "m.jsonl"),
                          "--checkpoint-dir", str(tmp_path / "cut")]) == 0
    out = capsys.readouterr()
    assert COUNTERS["bh.heals"] > heals
    assert json.loads(out.out.strip().splitlines()[-1])["bh_overflow"] == 0
    assert "mid-run" not in out.err
    records = (tmp_path / "m.jsonl").read_text().strip().splitlines()
    assert len(records) == 3
    assert not any("bh_overflow" in json.loads(r) for r in records)
    assert main(common + ["--bh-near-budget", "256", "--bh-far-budget",
                          "4096", "--checkpoint-dir", str(tmp_path / "wide")]
                ) == 0
    assert _last_json(capsys)["bh_overflow"] == 0
    got, _ = load_checkpoint(latest_checkpoint(tmp_path / "cut"), "cpu")
    want, _ = load_checkpoint(latest_checkpoint(tmp_path / "wide"), "cpu")
    for f in ("pos", "vel", "acc"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    # The same run through the library: the budgets its heal grew to.
    cal, state = prepare(SimConfig(n=4096, force="barnes_hut",
                                   bh_leaf_size=16, theta=0.72,
                                   bh_multipole=2, dt=0.001), "cpu")
    cfg = cal.calibrated(**cut)
    heal = ListHeal.of(cfg)
    run = api.make_run(cfg, 8, heal=heal)
    end = run(run(state))
    assert torch.equal(end.pos, got.pos)
    grown = {BUDGET_FIELDS[k]: v for k, v in heal.grown.items()}
    assert set(grown) == set(cut)
    _, grew = recalibrate_on_overflow(cfg.calibrated(**grown), end,
                                      list(grown))
    assert grew == {}
