"""Compute ops: force evaluation, integrators, diagnostics, tree building.
Counterpart of `parallelnbody_tpu/ops/`."""
