"""Spherical IC families. Counterpart of `parallelnbody_tpu/models/spheres.py`;
only `plummer` is ported so far.

Draws come from a CPU `torch.Generator`. They differ from the JAX package's
`jax.random` draws for the same seed, so tests that compare the two packages
hand the JAX ICs to the port (state.state_from_numpy).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from parallelnbody_tpu_torch.models.registry import register_ic
from parallelnbody_tpu_torch.state import torch_dtype


def _isotropic_unit_vectors(gen, n, dtype):
    """Uniform points on the unit sphere (normalised Gaussian triples)."""
    v = torch.randn((n, 3), generator=gen, dtype=dtype)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-30)


def _uniform(gen, n, dtype, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand((n,), generator=gen, dtype=dtype)


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at x, xp ascending (what
    jnp.interp computes inside the table range): torch.searchsorted finds
    the segment, a linear blend fills it."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    span = x1 - x0
    t = torch.where(span > 0, (x - x0) / torch.where(span > 0, span, 1.0),
                    torch.zeros_like(x))
    return f0 + t * (f1 - f0)


# ----------------------------------------------------------------- Plummer
# Velocity magnitude distribution for an isotropic Plummer model:
# g(q) ~ q^2 (1 - q^2)^{7/2}, v = q * v_esc(r), sampled by inverse CDF over a
# precomputed table (the JAX package's table, to the same 4097 points).
_Q_TABLE = np.linspace(0.0, 1.0, 4097)
_G_TABLE = _Q_TABLE**2 * (1.0 - _Q_TABLE**2) ** 3.5
_CDF_TABLE = np.concatenate([[0.0], np.cumsum((_G_TABLE[1:] + _G_TABLE[:-1]) * 0.5)])
_CDF_TABLE /= _CDF_TABLE[-1]


@register_ic("plummer")
def plummer(gen, cfg, n=None, dtype=None):
    """Isotropic Plummer sphere in virial equilibrium.

    Total mass 1, scale radius a = cfg.ic_size * 3*pi/16 (so that with
    cfg.ic_size = 1 the virial radius is 1 and E_tot = -1/4 when G = 1).
    Returned on the CPU; the caller moves the arrays to its device.
    """
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    a = cfg.ic_size * (3.0 * math.pi / 16.0)

    # Radius via inverse CDF of M(<r): r = a / sqrt(u^{-2/3} - 1).
    u = _uniform(gen, n, dtype, 1e-6, 1.0 - 1e-6)
    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    # Clip extreme outliers (keeps the domain bounded).
    r = torch.clamp(r, max=20.0 * a)
    pos = r[:, None] * _isotropic_unit_vectors(gen, n, dtype)

    # Speed: q ~ g(q) via table inverse-CDF, v = q * v_esc.
    uq = _uniform(gen, n, dtype)
    q = _interp(uq, torch.as_tensor(_CDF_TABLE, dtype=dtype),
                torch.as_tensor(_Q_TABLE, dtype=dtype))
    v_esc = math.sqrt(2.0) * (1.0 + (r / a) ** 2) ** (-0.25) / math.sqrt(a)
    vel = (q * v_esc)[:, None] * _isotropic_unit_vectors(gen, n, dtype)

    mass = torch.full((n,), 1.0 / n, dtype=dtype)
    pos = pos - pos.mean(dim=0)
    vel = vel - vel.mean(dim=0)
    return pos, vel, mass
