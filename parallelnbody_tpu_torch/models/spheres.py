"""Spherical IC families: Plummer, Hernquist, uniform, cold collapse, the
reference's slab, two-body, King and NFW. Counterpart of
`parallelnbody_tpu/models/spheres.py`.

All spheres are generated in N-body-ish units (total mass 1, G = cfg.g assumed
1 for the equilibrium velocity scalings) and then scaled by cfg.ic_size.

Draws come from a CPU `torch.Generator`, taken in a fixed order per family.
They differ from the JAX package's `jax.random` draws for the same seed, so
the two packages' ICs agree in distribution, not sample by sample (two_body
draws nothing and is equal); tests that compare the two packages' physics
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


def _centred(x):
    return x - x.mean(dim=0)


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
    return _centred(pos), _centred(vel), mass


# ---------------------------------------------------------------- Hernquist
@register_ic("hernquist")
def hernquist(gen, cfg, n=None, dtype=None):
    """Hernquist (1990) sphere; positions exact, velocities from the local
    virial scaling sigma^2 ~ G M(<r) / (2 (r + a)) (approximate
    equilibrium)."""
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    a = cfg.ic_size

    u = _uniform(gen, n, dtype, 1e-6, 1.0 - 1e-4)
    s = torch.sqrt(u)
    r = torch.clamp(a * s / (1.0 - s), max=50.0 * a)
    pos = r[:, None] * _isotropic_unit_vectors(gen, n, dtype)

    m_enc = (r / (r + a)) ** 2  # enclosed mass fraction
    sigma = torch.sqrt(m_enc / (2.0 * (r + a)))
    vel = sigma[:, None] * torch.randn((n, 3), generator=gen, dtype=dtype)

    mass = torch.full((n,), 1.0 / n, dtype=dtype)
    return _centred(pos), _centred(vel), mass


# ------------------------------------------------------------ uniform / cold
@register_ic("uniform_sphere")
def uniform_sphere(gen, cfg, n=None, dtype=None):
    """Uniform-density sphere of radius cfg.ic_size with small virial-ish
    random velocities."""
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    r = cfg.ic_size * _uniform(gen, n, dtype) ** (1.0 / 3.0)
    pos = r[:, None] * _isotropic_unit_vectors(gen, n, dtype)
    sigma = 0.3 / math.sqrt(cfg.ic_size)
    vel = sigma * torch.randn((n, 3), generator=gen, dtype=dtype)
    mass = torch.full((n,), 1.0 / n, dtype=dtype)
    return pos, _centred(vel), mass


@register_ic("cold_sphere")
def cold_sphere(gen, cfg, n=None, dtype=None):
    """Uniform sphere at rest: the classic cold-collapse test problem."""
    pos, _, mass = uniform_sphere(gen, cfg, n=n, dtype=dtype)
    return pos, torch.zeros_like(pos), mass


@register_ic("uniform_cube")
def uniform_cube(gen, cfg, n=None, dtype=None):
    """Uniform random cube [-s, s]^3, cold."""
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    s = cfg.ic_size
    pos = -s + 2.0 * s * torch.rand((n, 3), generator=gen, dtype=dtype)
    return pos, torch.zeros_like(pos), torch.full((n,), 1.0 / n, dtype=dtype)


# ------------------------------------------------------------- reference slab
@register_ic("reference_slab")
def reference_slab(gen, cfg, n=None, dtype=None):
    """The reference's only scene (CreateSpacePoints, OctreeSearch.cpp:58-72):

      * positions uniform in the slab [-S, S] x [-S, S] x [-S/10, S/10]
      * speeds 10 * U(25, 50) = U(250, 500) in a random direction
      * masses U(1, 5000)
      * particle 0 overridden to a central body: origin, at rest, mass 5000
        (OctreeSearch.cpp:68-70)

    Intended to be stepped with the compat profile (G=1e4, semi-implicit
    Euler, no softening): see `config.reference_compat_config`.
    """
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    s = cfg.ic_size
    extent = torch.tensor([s, s, s / 10.0], dtype=dtype)
    pos = (2.0 * torch.rand((n, 3), generator=gen, dtype=dtype) - 1.0) * extent
    speed = 10.0 * _uniform(gen, n, dtype, 25.0, 50.0)
    vel = speed[:, None] * _isotropic_unit_vectors(gen, n, dtype)
    mass = _uniform(gen, n, dtype, 1.0, 5000.0)

    pos[0] = 0.0
    vel[0] = 0.0
    mass[0] = 5000.0
    return pos, vel, mass


# ------------------------------------------------------------------ two body
@register_ic("two_body")
def two_body(gen, cfg, n=None, dtype=None):
    """Equal-mass circular binary (exact analytic orbit: integrator tests).
    Separation 2*ic_size; padded with far-away massless spectators if n > 2.
    Draws nothing."""
    del gen
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    a = cfg.ic_size
    m = 0.5
    # Each of the two masses m at +/- a orbits the COM at radius a with
    # v = sqrt(G * m / (4 a)).
    v = torch.sqrt(torch.tensor(cfg.g, dtype=dtype) * m / (4.0 * a))
    pos = torch.zeros((n, 3), dtype=dtype)
    vel = torch.zeros((n, 3), dtype=dtype)
    mass = torch.zeros((n,), dtype=dtype)
    pos[0, 0], pos[1, 0] = a, -a
    vel[0, 1], vel[1, 1] = v, -v
    mass[:2] = m
    if n > 2:
        # Park spectators on a distant ring so they do not perturb the binary.
        idx = torch.arange(n - 2, dtype=dtype)
        ang = 2.0 * math.pi * idx / max(n - 2, 1)
        ring = 1e4 * a
        pos[2:, 0] = ring * torch.cos(ang)
        pos[2:, 1] = ring * torch.sin(ang)
    return pos, vel, mass


# ---------------------------------------------------------------------- King
def _king_profile(w0, n_grid=2048):
    """(radii, enclosed-mass CDF) of the dimensionless King (1966) model
    W(r), integrated with numpy from the centre to the tidal radius (the JAX
    package's integration, step for step, so the table is the same)."""
    from math import erf, exp, pi, sqrt

    def rho_of_w(w):
        if w <= 0:
            return 0.0
        return exp(w) * erf(sqrt(w)) - sqrt(4 * w / pi) * (1 + 2 * w / 3)

    # Solve Poisson: (1/r^2) d/dr(r^2 dW/dr) = -9 rho/rho0
    rho0 = rho_of_w(w0)
    dr = 1e-3
    r, w, dwdr = dr, w0, 0.0
    rs, rhos = [0.0], [1.0]
    while w > 0 and r < 50:
        d2 = -9.0 * rho_of_w(w) / rho0 - (2.0 / r) * dwdr
        dwdr += d2 * dr
        w += dwdr * dr
        r += dr
        rs.append(r)
        rhos.append(max(rho_of_w(w) / rho0, 0.0))
    rs = np.asarray(rs)
    rhos = np.asarray(rhos)
    menc = np.concatenate([[0.0], np.cumsum(
        4 * np.pi * rs[1:] ** 2 * rhos[1:] * np.diff(rs))])
    return rs, menc / menc[-1]


@register_ic("king")
def king(gen, cfg, n=None, dtype=None, w0: float = 6.0):
    """King (1966) lowered-isothermal sphere, sampled approximately:
    positions from the numerically integrated King density profile,
    velocities from the local lowered-Maxwellian truncated at the escape
    speed."""
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    rs, cdf = _king_profile(w0)
    u = _uniform(gen, n, dtype, 1e-6, 1 - 1e-6)
    r = cfg.ic_size * _interp(u, torch.as_tensor(cdf, dtype=dtype),
                              torch.as_tensor(rs, dtype=dtype))
    pos = r[:, None] * _isotropic_unit_vectors(gen, n, dtype)
    # Local virial-ish dispersion, truncated near the tidal radius.
    rt = float(rs[-1]) * cfg.ic_size
    sigma = 0.4 * torch.sqrt(torch.clamp(1.0 - r / rt, 0.05, 1.0)
                             / max(cfg.ic_size, 1e-9))
    vel = sigma[:, None] * torch.randn((n, 3), generator=gen, dtype=dtype)
    mass = torch.full((n,), 1.0 / n, dtype=dtype)
    return _centred(pos), _centred(vel), mass


# ----------------------------------------------------------------------- NFW
@register_ic("nfw")
def nfw(gen, cfg, n=None, dtype=None, concentration: float = 10.0):
    """NFW halo truncated at r_200 = concentration * ic_size (scale radius
    ic_size); velocities from the local virial scaling (approximate)."""
    n = n or cfg.n
    dtype = torch_dtype(dtype or cfg.dtype)
    c = concentration
    rs_ = cfg.ic_size

    def m_of_x(x):  # enclosed mass of NFW in units of M(r200)
        return ((torch.log(1 + x) - x / (1 + x))
                / (math.log(1 + c) - c / (1 + c)))

    xs = torch.linspace(1e-3, c, 4096, dtype=torch.float64).to(dtype)
    cdf = m_of_x(xs)
    u = _uniform(gen, n, dtype, 1e-5, 1 - 1e-5)
    x = _interp(u, cdf / cdf[-1], xs)
    r = rs_ * x
    pos = r[:, None] * _isotropic_unit_vectors(gen, n, dtype)
    sigma = torch.sqrt(cfg.g * m_of_x(x) / (2.0 * torch.clamp(r, min=0.05 * rs_)))
    vel = sigma[:, None] * torch.randn((n, 3), generator=gen, dtype=dtype)
    mass = torch.full((n,), 1.0 / n, dtype=dtype)
    return _centred(pos), _centred(vel), mass
