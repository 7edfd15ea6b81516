"""An isotropic Plummer sphere from a seed, in numpy.

Aarseth, Henon & Wielen (1974, A&A 37, 183): radii by the inverse of the
enclosed mass, speeds q * v_esc with q drawn by rejection from
g(q) = q^2 (1 - q^2)^(7/2), isotropic directions. Units G = M = 1 with the
scale radius a = 3 pi / 16, so that the virial radius is 1 and the total
energy -1/4. The sphere is truncated at r_max = 20 a by drawing the mass
fraction from (0, M(< r_max)]; centre of mass and its velocity are moved to
the origin.

The measured window's inputs are one sphere, drawn from FIXED_SEED, in
the particle order that the run's seed draws (`initial_conditions`): every
seed hands the program the same particles, so every seed gives it the same
work. A sphere drawn from the seed (`sphere`) moved the calibrated list
budgets, and with them the time of a 262144 step, by up to 25% (PERF.md).
The comparison that decides `correct` also drives the program from the
sphere that the run's seed draws, so that a fault that shows on some
spheres only shows in some run.
"""

from __future__ import annotations

import math

import numpy as np

SCALE_RADIUS = 3.0 * math.pi / 16.0
R_MAX = 20.0          # truncation radius, in scale radii
G_MAX = 0.1           # above max g(q) = 0.0923 at q^2 = 2/9


def _directions(rng, n):
    cos_t = 2.0 * rng.random(n) - 1.0
    phi = 2.0 * math.pi * rng.random(n)
    sin_t = np.sqrt(1.0 - cos_t * cos_t)
    return np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], 1)


def _speed_fractions(rng, n):
    """n draws of q from g(q) = q^2 (1 - q^2)^(7/2) by rejection, in blocks
    of a fixed size so that the draws depend on the seed alone."""
    out = np.empty(0)
    block = 2 * n + 1024
    while out.size < n:
        x = rng.random(block)
        y = G_MAX * rng.random(block)
        out = np.concatenate([out, x[y < x * x * (1.0 - x * x) ** 3.5]])
    return out[:n]


def sphere(n, seed, size=1.0):
    """(pos (n, 3), vel (n, 3), mass (n,)) float64 of a Plummer sphere of
    total mass 1 and virial radius `size`, drawn from `seed` (any
    non-negative integer)."""
    rng = np.random.default_rng(int(seed))
    a = size * SCALE_RADIUS
    m_max = (R_MAX * R_MAX / (1.0 + R_MAX * R_MAX)) ** 1.5
    u = m_max * (1.0 - rng.random(n))                   # (0, m_max]
    r = a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _directions(rng, n)
    v_esc = math.sqrt(2.0 / a) * (1.0 + (r / a) ** 2) ** -0.25
    vel = (_speed_fractions(rng, n) * v_esc)[:, None] * _directions(rng, n)
    mass = np.full(n, 1.0 / n)
    return pos - pos.mean(0), vel - vel.mean(0), mass


FIXED_SEED = 0


def initial_conditions(n, seed, size=1.0):
    """(pos, vel, mass, order): the sphere of FIXED_SEED with its particles
    in the order that `seed` (any non-negative integer) draws; row j holds
    the sphere's particle order[j]."""
    pos, vel, mass = sphere(n, FIXED_SEED, size)
    order = np.random.default_rng(int(seed)).permutation(n)
    return pos[order], vel[order], mass[order], order
