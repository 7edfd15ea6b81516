"""Simulation state: SoA torch tensors on one device.

Counterpart of `parallelnbody_tpu/state.py`. The JAX state carries a PRNG key;
the port carries the integer seed instead, since nothing on the ported path
draws random numbers after the initial conditions.

`state_from_numpy` / `state_to_numpy` carry a state between the two packages
as numpy arrays (the JAX package's `SimState` fields of the same names).

States are made on the card unless the caller names another device
(`device="cpu"` runs the plain versions of the kernels, as the tests do);
without a card, a call that names no device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SimState(NamedTuple):
    """One snapshot of the simulation."""

    pos: torch.Tensor   # (N, 3) positions
    vel: torch.Tensor   # (N, 3) velocities
    mass: torch.Tensor  # (N,)   masses
    acc: torch.Tensor   # (N, 3) accelerations at `time`
    pot: torch.Tensor   # (N,)   potential per unit mass at each particle
    time: torch.Tensor  # ()     simulation time
    step: torch.Tensor  # ()     int32 step counter
    seed: int           # the seed the initial conditions were drawn from

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self):
        return self.pos.dtype


def torch_dtype(name) -> torch.dtype:
    """'float32' / 'float64' (SimConfig.dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return {"float32": torch.float32, "float64": torch.float64}[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; float32 or float64")


def resolve_device(device) -> torch.device:
    """torch.device(device); raises for a CUDA device when there is none,
    rather than carrying on somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return device


def make_state(pos, vel, mass, *, seed: int = 0, device="cuda",
               dtype=torch.float32) -> SimState:
    """Build a SimState from raw arrays on `device`; acc/pot start
    zeroed."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    pos = torch.as_tensor(pos, dtype=dtype, device=device)
    vel = torch.as_tensor(vel, dtype=dtype, device=device)
    mass = torch.as_tensor(mass, dtype=dtype, device=device)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {tuple(pos.shape)}")
    n = pos.shape[0]
    if tuple(vel.shape) != (n, 3):
        raise ValueError(f"vel must be ({n}, 3), got {tuple(vel.shape)}")
    if tuple(mass.shape) != (n,):
        raise ValueError(f"mass must be ({n},), got {tuple(mass.shape)}")
    return SimState(
        pos=pos, vel=vel, mass=mass,
        acc=torch.zeros_like(pos), pot=torch.zeros_like(mass),
        time=torch.zeros((), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        seed=int(seed),
    )


def state_from_numpy(arrays, device="cuda", dtype=torch.float32) -> SimState:
    """SimState from a mapping (or object with attributes) of numpy arrays
    named like the SimState fields: pos, vel, mass and optionally acc, pot,
    time, step and seed. Missing acc/pot start at zero."""
    def get(name, default=None):
        if isinstance(arrays, dict):
            return arrays.get(name, default)
        return getattr(arrays, name, default)

    dtype = torch_dtype(dtype)
    state = make_state(np.asarray(get("pos")), np.asarray(get("vel")),
                       np.asarray(get("mass")), seed=int(get("seed", 0)),
                       device=device, dtype=dtype)
    repl = {}
    for name in ("acc", "pot", "time"):
        v = get(name)
        if v is not None:
            repl[name] = torch.as_tensor(np.asarray(v), dtype=dtype,
                                         device=device)
    if get("step") is not None:
        repl["step"] = torch.as_tensor(np.asarray(get("step")),
                                       dtype=torch.int32, device=device)
    return state._replace(**repl)


def state_to_numpy(state: SimState) -> dict:
    """Dict of numpy arrays (host copies) of every SimState field."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in ("pos", "vel", "mass", "acc", "pot", "time", "step")}
    out["seed"] = state.seed
    return out
