"""Direct-sum O(N^2) gravity in plain torch. Counterpart of
`parallelnbody_tpu/ops/direct.py` (the jnp direct sum; the all-pairs kernel
K3 of force="direct_pallas" is ops/direct_kernels.py).

  * softening > 0: a_i = G * sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2};
    the i == j term vanishes (numerator zero, denominator > 0).
  * softening == 0: exact Newtonian force with the reference's exact-overlap
    guard `d == 0 -> skip` (OctreeSearch.h:102).

The potential phi_i = -G sum_j m_j / r_soft comes with the acceleration.
"""

from __future__ import annotations

import torch


def _pairwise_tile(pos_i, pos_j, mass_j, g, eps2, guard_zero):
    """Accel+potential on an (I, J) tile of the interaction matrix."""
    d = pos_j[None, :, :] - pos_i[:, None, :]           # (I, J, 3)
    r2 = torch.sum(d * d, dim=-1) + eps2
    inv_r = torch.rsqrt(r2)
    if guard_zero:
        inv_r = torch.where(r2 > 0.0, inv_r, torch.zeros_like(inv_r))
    w = mass_j[None, :] * inv_r * inv_r * inv_r
    acc = g * torch.einsum("ij,ijc->ic", w, d)
    pot = -g * torch.sum(mass_j[None, :] * inv_r, dim=1)
    return acc, pot


def direct_accel_tile(pos_i, pos_j, mass_j, *, g, softening):
    """Interactions of targets `pos_i` with sources (`pos_j`, `mass_j`)."""
    return _pairwise_tile(pos_i, pos_j, mass_j, g, float(softening) ** 2,
                          guard_zero=(softening == 0.0))


def direct_accel(pos, mass, *, g=1.0, softening=0.0, tile=0):
    """Full O(N^2) accelerations and potentials. tile > 0 streams row
    blocks of that many targets to bound memory to O(tile * N)."""
    n = pos.shape[0]
    if tile and n % tile == 0 and n > tile:
        parts = [direct_accel_tile(pos[i0:i0 + tile], pos, mass, g=g,
                                   softening=softening)
                 for i0 in range(0, n, tile)]
        return (torch.cat([a for a, _ in parts]),
                torch.cat([p for _, p in parts]))
    return direct_accel_tile(pos, pos, mass, g=g, softening=softening)


def direct_energy(pos, vel, mass, *, g=1.0, softening=0.0):
    """(KE, PE) via the direct pairwise sum. PE counts each pair once."""
    _, pot = direct_accel(pos, mass, g=g, softening=softening)
    ke = 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1))
    pe = 0.5 * torch.sum(mass * pot)
    return ke, pe
