"""Initial-condition model families. Counterpart of
`parallelnbody_tpu/models/`: the reference's slab scene (`reference_slab`),
the Plummer, Hernquist, King and NFW spheres, uniform cube and sphere, the
cold-collapse sphere, the two-body binary, the rotating disk and the
two-Plummer galaxy collision.

Every generator has the signature

    gen(generator: torch.Generator, cfg: SimConfig) -> (pos (N,3), vel (N,3), mass (N,))

drawing from a CPU `torch.Generator`, so the same seed gives the same ICs
whichever device the run uses afterwards.
"""

from parallelnbody_tpu_torch.models.registry import get_ic, register_ic, IC_REGISTRY

# Importing registers the built-in families.
from parallelnbody_tpu_torch.models import spheres as _spheres  # noqa: F401
from parallelnbody_tpu_torch.models import disk as _disk  # noqa: F401
from parallelnbody_tpu_torch.models import scenes as _scenes  # noqa: F401

__all__ = ["get_ic", "register_ic", "IC_REGISTRY"]
