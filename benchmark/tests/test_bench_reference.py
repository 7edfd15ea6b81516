"""The reference, the inputs and the yardstick against brute force."""

import math

import numpy as np
import pytest
import torch

from benchmark import trace as tracing, yardstick
from benchmark.inputs import plummer
from benchmark.reference import nbody


def _brute(tgt, src, mass, g, eps, skip=None):
    out = np.zeros_like(tgt)
    for i, x in enumerate(tgt):
        for j, y in enumerate(src):
            if skip is not None and skip[i] == j:
                continue
            d = y - x
            out[i] += g * mass[j] * d / (d @ d + eps * eps) ** 1.5
    return out


def _sphere(n, seed=3):
    pos, vel, mass = plummer.sphere(n, seed)
    return (torch.as_tensor(pos), torch.as_tensor(vel),
            torch.as_tensor(mass))


def test_direct_sum_matches_brute_force():
    pos, _, mass = _sphere(300)
    idx = torch.arange(0, 300, 7)
    got = nbody.accel_at(pos[idx], pos, mass, g=1.3, softening=0.02,
                         self_index=idx).numpy()
    want = _brute(pos[idx].numpy(), pos.numpy(), mass.numpy(), 1.3, 0.02,
                  skip=idx.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_direct_sum_streams_over_blocks(monkeypatch):
    pos, _, mass = _sphere(500)
    whole = nbody.accel_at(pos[:40], pos, mass, g=1.0, softening=0.01)
    monkeypatch.setattr(nbody, "PAIRS_PER_BLOCK", 40 * 64)
    blocked = nbody.accel_at(pos[:40], pos, mass, g=1.0, softening=0.01)
    torch.testing.assert_close(blocked, whole, rtol=1e-13, atol=0)


def test_softening_zero_leaves_coincident_pairs_out():
    pos, _, mass = _sphere(64)
    got = nbody.accel_at(pos, pos, mass, g=1.0, softening=0.0)
    assert torch.isfinite(got).all()
    want = nbody.accel_at(pos, pos, mass, g=1.0, softening=0.0,
                          self_index=torch.arange(64))
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)


def test_leapfrog_at_follows_the_whole_system():
    """The targets' trajectory with straight-line sources against every
    particle integrated together, float64, 8 steps: the straight line
    costs far less than the float32 rounding the comparison sees."""
    pos, vel, mass = _sphere(512)
    dt, eps, steps = 1e-4, 0.01, 8
    idx = torch.tensor([0, 17, 100, 255, 511])
    x, v = pos.clone(), vel.clone()
    every = torch.arange(512)
    a = nbody.accel_at(x, x, mass, g=1.0, softening=eps, self_index=every)
    for _ in range(steps):
        v = v + 0.5 * dt * a
        x = x + dt * v
        a = nbody.accel_at(x, x, mass, g=1.0, softening=eps,
                           self_index=every)
        v = v + 0.5 * dt * a
    a0, xt, vt, at = nbody.leapfrog_at(pos, vel, mass, idx, steps=steps,
                                       dt=dt, g=1.0, softening=eps)
    dx = x[idx] - pos[idx]
    dv = v[idx] - vel[idx]
    assert float((xt - x[idx]).norm() / dx.norm()) < 1e-7
    assert float((vt - v[idx]).norm() / dv.norm()) < 1e-5
    assert float((at - a[idx]).norm() / a[idx].norm()) < 1e-5
    torch.testing.assert_close(
        a0, nbody.accel_at(pos[idx], pos, mass, g=1.0, softening=eps,
                           self_index=idx), rtol=0, atol=0)


def test_rms_force_error_sample():
    pos, _, mass = _sphere(400)
    exact = nbody.accel_at(pos, pos, mass, g=1.0, softening=0.01)
    assert nbody.rms_force_error_sample(pos, mass, exact, g=1.0,
                                        softening=0.01, k=100) < 1e-14
    off = exact * (1 + 1e-3)
    got = nbody.rms_force_error_sample(pos, mass, off, g=1.0,
                                       softening=0.01, k=100)
    assert abs(got - 1e-3) < 1e-9
    rows = nbody.strided(400, 100).flip(0)
    assert nbody.rms_force_error_sample(
        pos, mass, off, g=1.0, softening=0.01, idx=rows) == pytest.approx(
            got, rel=1e-12)


def test_plummer_inputs():
    big = 2**31 + 12345
    p1, v1, m1 = plummer.sphere(4096, big)
    p2, v2, m2 = plummer.sphere(4096, big)
    assert np.array_equal(p1, p2) and np.array_equal(v1, v2)
    assert not np.array_equal(p1, plummer.sphere(4096, 1)[0])
    assert p1.shape == (4096, 3) and v1.shape == (4096, 3)
    np.testing.assert_allclose(m1.sum(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(p1.mean(0), 0, atol=1e-12)
    np.testing.assert_allclose(v1.mean(0), 0, atol=1e-12)
    a = plummer.SCALE_RADIUS
    assert np.linalg.norm(p1, axis=1).max() < 21 * a
    # Virial equilibrium: 2K / |W| near 1 (W by the direct sum).
    ke = 0.5 * (m1 * (v1 * v1).sum(1)).sum()
    d = p1[:, None, :] - p1[None, :, :]
    r = np.sqrt((d * d).sum(-1))
    iu = np.triu_indices(4096, 1)
    w = -(m1[iu[0]] * m1[iu[1]] / r[iu]).sum()
    assert 0.9 < 2 * ke / -w < 1.1



def test_every_seed_orders_one_sphere():
    """The window's inputs: the same for one seed (a seed above 32 signed
    bits too), the fixed sphere's particles in another order for another
    seed, row j being particle order[j]."""
    big = 2**31 + 12345
    a = plummer.initial_conditions(1000, big)
    b = plummer.initial_conditions(1000, big)
    c = plummer.initial_conditions(1000, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    fixed = plummer.sphere(1000, plummer.FIXED_SEED)
    for pos, vel, mass, order in (a, c):
        assert np.array_equal(pos, fixed[0][order])
        assert np.array_equal(vel, fixed[1][order])


def test_the_drawn_sphere_is_the_seeds_own():
    """The comparison's second inputs: another sphere for another seed."""
    rows = lambda t: np.sort(np.concatenate([t[0], t[1]], 1).view(
        [("", float)] * 6), axis=0)
    big = 2**31 + 12345
    assert np.array_equal(rows(plummer.sphere(1000, big)),
                          rows(plummer.sphere(1000, big)))
    assert not np.array_equal(rows(plummer.sphere(1000, big)),
                              rows(plummer.sphere(1000, 7)))


def test_k3_work_and_least_time():
    n = 262144
    least, res = yardstick.least_seconds(float(n) ** 2,
                                         yardstick.FLOPS_MONOPOLE, 28 * n)
    assert res == "fp32"
    assert math.isclose(least, n * n * 18 / 67e12, rel_tol=1e-12)
    assert math.isclose(1e3 * least, 18.462, rel_tol=1e-4)


def test_percentile():
    vals = list(range(1, 101))
    assert yardstick.p95(vals) == 95
    assert yardstick.p95([3.0]) == 3.0
    assert yardstick.p95(list(range(200, 0, -1))) == 190


def test_hand_kernels_of_the_program():
    import parallelnbody_tpu_torch

    names = tracing.hand_kernels(parallelnbody_tpu_torch.__path__[0])
    assert {"near_field_kernel", "near_combine_kernel", "far_octet_kernel",
            "allpairs_kernel", "allpairs_combine_kernel"} <= names
