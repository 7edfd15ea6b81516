"""Snapshot / trajectory / checkpoint IO. Counterpart of
`parallelnbody_tpu/utils/io.py`.

File format (numpy .npz, written with np.savez_compressed; every array is a
host copy of the state's tensor, in the state's dtype):

  * Snapshot `<name>.npz`: pos (N, 3), vel (N, 3), mass (N,), acc (N, 3),
    pot (N,), time (), step () int32, and seed () int64: the integer seed
    the initial conditions were drawn from (the port's SimState carries
    it in place of the JAX package's PRNG key). `extra_<k>` arrays may
    follow. A JAX package snapshot stores `key` (raw PRNG key data) where
    this one stores `seed`; load_snapshot reads either, ignores `key`,
    and takes the seed from its argument (default 0).
  * Checkpoint: the snapshot `ckpt_<step:010d>.npz` plus the run's
    SimConfig as JSON beside it, `ckpt_<step:010d>.json`. A run resumed
    from a checkpoint is bit-identical to one that never stopped.
    load_checkpoint reads the JAX package's checkpoints as well, taking
    the seed from the config JSON.
  * Trajectory directory: `manifest.json` = {"frames": [{"step", "time",
    "file"}, ...], "config": SimConfig as a dict or null} and one
    `snap_<step:010d>.npz` a frame holding pos and mass (or a full
    snapshot with positions_only=False). Both packages write and read it
    alike.

Loaders put the state on the card unless the caller names another device.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.state import SimState, state_from_numpy

_ARRAYS = ("pos", "vel", "mass", "acc", "pot", "time", "step")


def _state_to_arrays(state: SimState) -> dict:
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in _ARRAYS}
    out["seed"] = np.asarray(state.seed, np.int64)
    return out


def save_snapshot(path, state: SimState, extra: dict | None = None) -> Path:
    """Write one snapshot as .npz. Returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = _state_to_arrays(state)
    if extra:
        arrays.update({f"extra_{k}": np.asarray(v) for k, v in extra.items()})
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return path


def load_snapshot(path, device="cuda", seed: int = 0) -> SimState:
    """SimState from a snapshot of either package on `device`; `seed` is
    used where the file stores none (a JAX package snapshot)."""
    with np.load(path) as z:
        arrays = {name: z[name] for name in _ARRAYS}
        arrays["seed"] = int(z["seed"]) if "seed" in z.files else int(seed)
    return state_from_numpy(arrays, device=device,
                            dtype=str(arrays["pos"].dtype))


# ----------------------------------------------------------------- checkpoint
def save_checkpoint(ckpt_dir, state: SimState, cfg: SimConfig) -> Path:
    """Checkpoint = snapshot + config, named by step."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = int(state.step)
    path = ckpt_dir / f"ckpt_{step:010d}.npz"
    save_snapshot(path, state)
    (ckpt_dir / f"ckpt_{step:010d}.json").write_text(cfg.to_json())
    return path


def latest_checkpoint(ckpt_dir) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    ckpts = sorted(ckpt_dir.glob("ckpt_*.npz"))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path, device="cuda") -> tuple[SimState, SimConfig]:
    path = Path(path)
    cfg = SimConfig.from_json(path.with_suffix(".json").read_text())
    return load_snapshot(path, device, seed=cfg.seed), cfg


# ----------------------------------------------------------------- trajectory
class TrajectoryWriter:
    """Rolling series of snapshots + manifest.json, for an external viewer.

    Layout: <dir>/manifest.json, <dir>/snap_<step>.npz (module docstring).
    The manifest lists frames in order with sim time. Each frame copies the
    state's pos and mass to the host once.
    """

    def __init__(self, directory, cfg: SimConfig | None = None,
                 positions_only: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.positions_only = positions_only
        self.frames: list[dict] = []
        self._cfg = cfg
        # A resumed run pointing at an existing snapshot dir appends to the
        # replay sequence instead of truncating it (frames past the resume
        # step are dropped: the rerun overwrites them).
        manifest = self.dir / "manifest.json"
        if manifest.is_file():
            try:
                self.frames = json.loads(manifest.read_text()).get("frames", [])
            except (json.JSONDecodeError, OSError):
                self.frames = []

    def append(self, state: SimState) -> Path:
        step = int(state.step)
        self.frames = [f for f in self.frames if f["step"] < step]
        t = float(state.time)
        path = self.dir / f"snap_{step:010d}.npz"
        if self.positions_only:
            arrays = {"pos": state.pos.detach().cpu().numpy(),
                      "mass": state.mass.detach().cpu().numpy()}
            with open(path, "wb") as f:
                np.savez_compressed(f, **arrays)
        else:
            save_snapshot(path, state)
        self.frames.append({"step": step, "time": t, "file": path.name})
        self._write_manifest()
        return path

    def _write_manifest(self):
        manifest = {
            "frames": self.frames,
            "config": json.loads(self._cfg.to_json()) if self._cfg else None,
        }
        (self.dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
