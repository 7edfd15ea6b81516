"""The golden trajectory of tests/test_golden.py through the port: 100 f64
leapfrog steps of the direct sum at N = 64 (seed 42, softening 0.05,
dt 1e-3), held against tests/golden/plummer64_100steps.npz at rtol 1e-10 /
atol 1e-12. The golden file stores only the final pos / vel and the port
draws its own ICs, so the run starts from the JAX package's ICs and t = 0
forces, carried over as numpy arrays (state_from_numpy); every step after
that is the port's make_run."""

from pathlib import Path

import numpy as np
import torch

from parallelnbody_tpu.api import init_simulation as jax_init
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu_torch.api import make_run
from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.state import state_from_numpy

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden" / "plummer64_100steps.npz"
KW = dict(n=64, ic="plummer", dt=1e-3, softening=0.05, integrator="leapfrog",
          force="direct", dtype="float64", seed=42)


def test_golden_trajectory_through_port():
    ic = jax_init(JaxConfig(**KW))
    state = state_from_numpy(
        {k: np.array(getattr(ic, k))
         for k in ("pos", "vel", "mass", "acc", "pot", "time", "step")},
        device="cpu", dtype=torch.float64)
    out = make_run(SimConfig(**KW), 100)(state)
    assert int(out.step) == 100
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(out.pos.numpy(), z["pos"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(out.vel.numpy(), z["vel"], rtol=1e-10,
                                   atol=1e-12)
