"""Compute ops: force evaluation, integrators, diagnostics, tree building.
Counterpart of `parallelnbody_tpu/ops/`, with the same nine re-exports."""

from parallelnbody_tpu_torch.ops.direct import direct_accel, direct_accel_tile
from parallelnbody_tpu_torch.ops.integrators import get_integrator
from parallelnbody_tpu_torch.ops.energy import (
    kinetic_energy,
    potential_energy,
    total_energy,
    momentum,
    angular_momentum,
    diagnostics,
)

__all__ = [
    "direct_accel",
    "direct_accel_tile",
    "get_integrator",
    "kinetic_energy",
    "potential_energy",
    "total_energy",
    "momentum",
    "angular_momentum",
    "diagnostics",
]
