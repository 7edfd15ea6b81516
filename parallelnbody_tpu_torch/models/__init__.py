"""Initial-condition model families. Counterpart of
`parallelnbody_tpu/models/`; only the Plummer sphere is ported so far.

Every generator has the signature

    gen(generator: torch.Generator, cfg: SimConfig) -> (pos (N,3), vel (N,3), mass (N,))

drawing from a CPU `torch.Generator`, so the same seed gives the same ICs
whichever device the run uses afterwards.
"""

from parallelnbody_tpu_torch.models.registry import get_ic, register_ic, IC_REGISTRY

# Importing registers the built-in families.
from parallelnbody_tpu_torch.models import spheres as _spheres  # noqa: F401

__all__ = ["get_ic", "register_ic", "IC_REGISTRY"]
