"""Auxiliary subsystems: snapshot/trajectory IO, checkpointing, metrics,
profiling, debugging, rendering and the force-accuracy sampler.
Counterpart of `parallelnbody_tpu/utils/`; the JAX package's compile cache
(utils/cache.py, XLA's persistent cache) has no counterpart here."""

from parallelnbody_tpu_torch.utils.io import (
    save_snapshot,
    load_snapshot,
    save_checkpoint,
    load_checkpoint,
    latest_checkpoint,
    TrajectoryWriter,
)
from parallelnbody_tpu_torch.utils.metrics import MetricsLogger
from parallelnbody_tpu_torch.utils.profiling import profile_trace

__all__ = [
    "save_snapshot",
    "load_snapshot",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "TrajectoryWriter",
    "MetricsLogger",
    "profile_trace",
]
