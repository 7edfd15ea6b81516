"""parallelnbody_tpu_torch — the PyTorch/CUDA port of parallelnbody_tpu.

A second package beside the JAX package `parallelnbody_tpu`, which stays the
reference it is tested against. Module and function names follow the JAX
package so that each counterpart is easy to find. Plain tensor code is
PyTorch; the TPU's Pallas kernels on the ported path are CUDA C++ kernels
for Hopper (csrc/, built at first use by kernels/build.py).

Ported: the single-device Barnes-Hut path with dense or staged
refinement, either far field (octet or gather) and target sections, the
all-pairs path (force="direct_pallas"), both through
`Simulation(cfg, device="cuda")`, all eleven IC families and
`config.reference_compat_config`, the plain direct sum, the six integrators
and the diagnostics; `utils/` (snapshots, checkpoints, trajectories,
metrics, profiling, debug checks, rendering), the C++ oracle (`native/`)
and the command line (`python -m parallelnbody_tpu_torch`, cli.py); the
multi-device paths (`parallel/`: the ring all-pairs schedule, the
replicated-tree and the distributed Barnes-Hut with ring and LET near
fields, one process per rank). This package never imports JAX.
"""

from parallelnbody_tpu_torch.config import SimConfig, reference_compat_config
from parallelnbody_tpu_torch.state import SimState
from parallelnbody_tpu_torch.api import (Simulation, calibrate_budgets,
                                         init_simulation, make_run, make_step,
                                         prepare_simulation)

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "SimState",
    "Simulation",
    "make_step",
    "make_run",
    "init_simulation",
    "prepare_simulation",
    "calibrate_budgets",
    "reference_compat_config",
    "__version__",
]
