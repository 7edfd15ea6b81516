"""Conserved-quantity diagnostics: energy, momentum, angular momentum.
Counterpart of `parallelnbody_tpu/ops/energy.py`."""

from __future__ import annotations

import torch


def kinetic_energy(vel, mass):
    return 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1))


def potential_energy(pot, mass):
    """Total PE from per-particle potentials phi_i = -G sum_j m_j / r_ij.
    The 1/2 corrects double counting of pairs. With softening > 0 every
    force method includes the constant self-term -G m_i / eps in phi_i, as
    in the JAX package."""
    return 0.5 * torch.sum(mass * pot)


def total_energy(vel, mass, pot):
    return kinetic_energy(vel, mass) + potential_energy(pot, mass)


def momentum(vel, mass):
    return torch.sum(mass[:, None] * vel, dim=0)


def angular_momentum(pos, vel, mass):
    return torch.sum(mass[:, None] * torch.linalg.cross(pos, vel), dim=0)


def diagnostics(state) -> dict:
    """Scalar diagnostics dict for one state (device tensors; caller converts)."""
    ke = kinetic_energy(state.vel, state.mass)
    pe = potential_energy(state.pot, state.mass)
    p = momentum(state.vel, state.mass)
    L = angular_momentum(state.pos, state.vel, state.mass)
    return {
        "time": state.time,
        "step": state.step,
        "kinetic": ke,
        "potential": pe,
        "energy": ke + pe,
        "momentum_norm": torch.linalg.vector_norm(p),
        "angular_momentum_norm": torch.linalg.vector_norm(L),
        "max_accel": torch.max(torch.linalg.vector_norm(state.acc, dim=-1)),
        "max_radius": torch.max(torch.linalg.vector_norm(state.pos, dim=-1)),
    }
