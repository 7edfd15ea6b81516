"""Rotating-disk IC family (exponential disk on near-circular orbits).
Counterpart of `parallelnbody_tpu/models/disk.py`."""

from __future__ import annotations

import math

import torch

from parallelnbody_tpu_torch.models.registry import register_ic
from parallelnbody_tpu_torch.models.spheres import _interp, _uniform
from parallelnbody_tpu_torch.state import torch_dtype


@register_ic("disk")
def exponential_disk(gen, cfg, n=None, dtype=None, center=None, velocity=None,
                     spin=None):
    """Cold-ish exponential disk: surface density ~ exp(-R/Rd), thin
    Gaussian vertical profile, circular velocity from the enclosed disk mass
    (monopole approximation) plus small velocity dispersion.

    Optional center/velocity/spin let composite scenes place and orient disks.
    """
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    rd = cfg.ic_size

    # Sample R from the exponential-disk cumulative mass profile
    # M(<R)/M = 1 - (1 + R/Rd) exp(-R/Rd), inverted on a table.
    u = _uniform(gen, n, dtype, 1e-6, 1.0 - 1e-6)
    r_grid = torch.linspace(0.0, 12.0, 4096, dtype=torch.float64).to(dtype)
    cdf = 1.0 - (1.0 + r_grid) * torch.exp(-r_grid)
    x = _interp(u, cdf / cdf[-1], r_grid)  # R / Rd
    r = rd * x

    phi = _uniform(gen, n, dtype, 0.0, 2.0 * math.pi)
    z = 0.05 * rd * torch.randn((n,), generator=gen, dtype=dtype)
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)

    # Circular speed from enclosed mass (spherical monopole approx).
    m_enc = 1.0 - (1.0 + x) * torch.exp(-x)
    v_c = torch.sqrt(cfg.g * m_enc / torch.clamp(r, min=0.05 * rd))
    tangent = torch.stack([-torch.sin(phi), torch.cos(phi),
                           torch.zeros_like(phi)], dim=-1)
    vel = v_c[:, None] * tangent
    vel = vel + 0.05 * v_c[:, None] * torch.randn((n, 3), generator=gen,
                                                  dtype=dtype)

    if spin is not None and spin < 0:
        vel = -vel
    mass = torch.full((n,), 1.0 / n, dtype=dtype)
    if center is not None:
        pos = pos + torch.as_tensor(center, dtype=dtype)
    if velocity is not None:
        vel = vel + torch.as_tensor(velocity, dtype=dtype)
    return pos, vel, mass
