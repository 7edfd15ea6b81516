"""The direct-sum potential of benchmark/reference/potential.py against a
dense float64 sum written out pair by pair, N = 512."""

import numpy as np
import torch

from benchmark import harness
from benchmark.inputs import plummer
from benchmark.reference import nbody, potential
from benchmark.tests.test_bench_imports import _tops

N = 512


def _sphere(n=N, seed=7):
    pos, _, mass = plummer.sphere(n, seed)
    return torch.as_tensor(pos), torch.as_tensor(mass)


def _dense(tgt, src, mass, g, eps, skip=None):
    out = np.zeros(len(tgt))
    for i, x in enumerate(tgt):
        for j, y in enumerate(src):
            if skip is not None and skip[i] == j:
                continue
            d = y - x
            r2 = d @ d + eps * eps
            if r2 > 0:
                out[i] -= g * mass[j] / np.sqrt(r2)
    return out


def test_potential_matches_the_dense_sum():
    pos, mass = _sphere()
    idx = torch.arange(0, N, 5)
    got = potential.potential_at(pos[idx], pos, mass, g=1.3, softening=0.02,
                                 self_index=idx).numpy()
    want = _dense(pos[idx].numpy(), pos.numpy(), mass.numpy(), 1.3, 0.02,
                  skip=idx.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_without_self_index_a_target_meets_itself_at_the_softening():
    """Every target is a source: its own row adds -g m_i / eps, the
    program's convention."""
    pos, mass = _sphere()
    idx = torch.arange(0, N, 3)
    kw = dict(g=0.7, softening=0.05)
    whole = potential.potential_at(pos[idx], pos, mass, **kw)
    left_out = potential.potential_at(pos[idx], pos, mass, self_index=idx,
                                      **kw)
    torch.testing.assert_close(whole, left_out - 0.7 * mass[idx] / 0.05,
                               rtol=1e-13, atol=0)
    want = _dense(pos[idx].numpy(), pos.numpy(), mass.numpy(), 0.7, 0.05)
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-12, atol=0)


def test_potential_streams_over_blocks(monkeypatch):
    pos, mass = _sphere()
    whole = potential.potential_at(pos[:40], pos, mass, g=1.0,
                                   softening=0.01)
    monkeypatch.setattr(potential, "PAIRS_PER_BLOCK", 40 * 64)
    blocked = potential.potential_at(pos[:40], pos, mass, g=1.0,
                                     softening=0.01)
    torch.testing.assert_close(blocked, whole, rtol=1e-13, atol=0)


def test_softening_zero_leaves_coincident_pairs_out():
    pos, mass = _sphere(64)
    got = potential.potential_at(pos, pos, mass, g=1.0, softening=0.0)
    assert torch.isfinite(got).all()
    want = potential.potential_at(pos, pos, mass, g=1.0, softening=0.0,
                                  self_index=torch.arange(64))
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)


def test_potential_is_the_acceleration_field_s_source():
    """-grad phi = a: a central difference of the potential at a few
    targets against accel_at, both float64 and softened alike."""
    pos, mass = _sphere()
    tgt = pos[:6] * 1.5 + 0.01
    kw = dict(g=1.0, softening=0.02)
    h = 1e-5
    grad = torch.stack([
        (potential.potential_at(tgt + h * e, pos, mass, **kw)
         - potential.potential_at(tgt - h * e, pos, mass, **kw)) / (2 * h)
        for e in torch.eye(3, dtype=pos.dtype)], dim=1)
    torch.testing.assert_close(-grad, nbody.accel_at(tgt, pos, mass, **kw),
                               rtol=1e-6, atol=1e-9)


def test_potential_loads_nothing_of_the_program():
    tops = _tops("import benchmark.reference.potential")
    assert not tops & ({"parallelnbody_tpu_torch"} | harness.FORBIDDEN)
