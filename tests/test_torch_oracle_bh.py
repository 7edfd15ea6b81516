"""The Barnes-Hut energy-drift gate of tests/test_oracle.py:90 through the
port on the CPU: 1000 f32 leapfrog steps, theta 0.5, leaf 32, quadrupole,
the tree rebuilt every step, from the port's own Plummer ICs; energy by the
port's float64 C++ oracle (native/). Drift below 1e-6 (the JAX package
measured 4.1e-8 on its ICs) and below the 1e-4 baseline criterion; no
list overflow. A file of its own: 1000 CPU steps take about a minute."""

import shutil

import pytest
import torch

from parallelnbody_tpu_torch.api import init_simulation, make_run
from parallelnbody_tpu_torch.config import SimConfig

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

CFG = SimConfig(n=2048, ic="plummer", softening=0.05, dt=1e-3,
                integrator="leapfrog", force="barnes_hut", theta=0.5,
                bh_leaf_size=32, bh_near_budget=64, bh_far_budget=256,
                bh_multipole=2, dtype="float32", bh_rebuild_every=1)


def test_bh_energy_drift_1000_steps_through_port():
    from parallelnbody_tpu_torch.api import _reuse_eligible
    from parallelnbody_tpu_torch.native import Oracle

    assert not _reuse_eligible(CFG, 1000)       # the per-step program
    state = init_simulation(CFG, device="cpu")
    pos0, vel0 = state.pos.numpy(), state.vel.numpy()
    mass = state.mass.numpy()
    oracle = Oracle(g=1.0, softening=0.05)

    e0 = oracle.total_energy(pos0, vel0, mass)
    out, overflow = make_run(CFG, 1000, report_overflow=True)(state)
    assert int(overflow) == 0
    e1 = oracle.total_energy(out.pos.numpy(), out.vel.numpy(), mass)
    drift = abs((e1 - e0) / e0)
    assert drift < 1e-4, f"baseline criterion violated: drift {drift}"
    assert drift < 1e-6, f"Barnes-Hut drift regression: {drift}"
