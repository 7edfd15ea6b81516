"""Composite scenes: the galaxy collision. Counterpart of
`parallelnbody_tpu/models/scenes.py`.

`galaxy_collision`: two Plummer spheres (mass ratio 1:1) on an approaching
parabolic-ish orbit with an impact parameter, the N = 2M scene of
`examples/galaxy_2m.json`.
"""

from __future__ import annotations

import math

import torch

from parallelnbody_tpu_torch.models.registry import register_ic
from parallelnbody_tpu_torch.models.spheres import plummer
from parallelnbody_tpu_torch.state import torch_dtype


@register_ic("galaxy_collision")
def galaxy_collision(gen, cfg, n=None, dtype=None):
    """Two unit-mass Plummer spheres of n // 2 and n - n // 2 particles,
    separated along x with an impact parameter along y, approaching each
    other. One generator feeds both halves in turn: the first sphere takes
    its draws, then the second, so a seed fixes the scene."""
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    n1 = n // 2
    n2 = n - n1

    pos1, vel1, m1 = plummer(gen, cfg, n=n1, dtype=dtype)
    pos2, vel2, m2 = plummer(gen, cfg, n=n2, dtype=dtype)

    sep = 10.0 * cfg.ic_size       # initial separation along x
    b = 2.0 * cfg.ic_size          # impact parameter along y
    # Relative speed ~ parabolic encounter of two unit-mass galaxies at r=sep.
    v_rel = math.sqrt(2.0 * cfg.g * (1.0 + 1.0) / sep)

    off = torch.tensor([sep / 2.0, b / 2.0, 0.0], dtype=dtype)
    voff = torch.tensor([v_rel / 2.0, 0.0, 0.0], dtype=dtype)

    pos = torch.cat([pos1 - off, pos2 + off], dim=0)
    vel = torch.cat([vel1 + voff, vel2 - voff], dim=0)
    # Each half keeps total mass 1 (masses 1/n_half) so each galaxy is an
    # equilibrium Plummer model of unit mass; total system mass = 2.
    mass = torch.cat([m1, m2], dim=0)
    return pos, vel, mass
