"""Time integrators. Counterpart of `parallelnbody_tpu/ops/integrators.py`;
the bodies are the same elementwise arithmetic on torch tensors.

The reference uses fixed-dt semi-implicit (symplectic) Euler inside its
per-frame Tick (`v += dt*a; x += dt*v`, OctreeSearch.cpp:28-31) — provided
here as `euler_semi_implicit` for the compat profile. The default profile is
kick-drift-kick leapfrog (velocity Verlet), which is 2nd-order symplectic and
needs one force evaluation per step by caching the acceleration.

Contract: every integrator is a pure function

    step(accel_fn, pos, vel, acc, pot, dt) -> (pos, vel, acc, pot)

where on entry (acc, pot) are valid at `pos`, and on exit they are valid at
the returned `pos` (so diagnostics after a step are free, and the next step
can reuse them). `accel_fn(pos) -> (acc, pot)` closes over masses and physics
constants and may be the direct sum or Barnes-Hut.
"""

from __future__ import annotations

# Yoshida (1990) 4th-order symplectic composition coefficients.
_CBRT2 = 2.0 ** (1.0 / 3.0)
_YOSH_W1 = 1.0 / (2.0 - _CBRT2)
_YOSH_W0 = -_CBRT2 * _YOSH_W1
_YOSH_C = (_YOSH_W1 / 2.0, (_YOSH_W0 + _YOSH_W1) / 2.0, (_YOSH_W0 + _YOSH_W1) / 2.0, _YOSH_W1 / 2.0)
_YOSH_D = (_YOSH_W1, _YOSH_W0, _YOSH_W1)


def euler_semi_implicit(accel_fn, pos, vel, acc, pot, dt):
    """Reference-compat: kick with a(x_t), then drift with the new velocity
    (OctreeSearch.cpp:28-31). First-order, symplectic."""
    vel = vel + dt * acc
    pos = pos + dt * vel
    acc, pot = accel_fn(pos)
    return pos, vel, acc, pot


def euler_explicit(accel_fn, pos, vel, acc, pot, dt):
    """Plain forward Euler (non-symplectic; for comparison/testing only)."""
    new_pos = pos + dt * vel
    vel = vel + dt * acc
    acc, pot = accel_fn(new_pos)
    return new_pos, vel, acc, pot


def leapfrog_kdk(accel_fn, pos, vel, acc, pot, dt):
    """Kick-drift-kick leapfrog (velocity Verlet). 2nd-order symplectic,
    one force evaluation per step."""
    vel_half = vel + (0.5 * dt) * acc
    pos = pos + dt * vel_half
    acc, pot = accel_fn(pos)
    vel = vel_half + (0.5 * dt) * acc
    return pos, vel, acc, pot


def leapfrog_dkd(accel_fn, pos, vel, acc, pot, dt):
    """Drift-kick-drift leapfrog. 2nd-order symplectic; two evaluations per
    step under this contract (the mid-point kick plus the exit refresh)."""
    pos_half = pos + (0.5 * dt) * vel
    acc_mid, _ = accel_fn(pos_half)
    vel = vel + dt * acc_mid
    pos = pos_half + (0.5 * dt) * vel
    acc, pot = accel_fn(pos)
    return pos, vel, acc, pot


def yoshida4(accel_fn, pos, vel, acc, pot, dt):
    """Yoshida 4th-order symplectic composition (3 kicks, 4 drifts)."""
    pos = pos + (_YOSH_C[0] * dt) * vel
    for i in range(3):
        a_i, _ = accel_fn(pos)
        vel = vel + (_YOSH_D[i] * dt) * a_i
        pos = pos + (_YOSH_C[i + 1] * dt) * vel
    acc, pot = accel_fn(pos)
    return pos, vel, acc, pot


def rk4(accel_fn, pos, vel, acc, pot, dt):
    """Classical RK4 on (x, v). Non-symplectic, 4th-order; for comparison."""
    a1 = acc
    k1x, k1v = vel, a1

    a2, _ = accel_fn(pos + 0.5 * dt * k1x)
    k2x, k2v = vel + 0.5 * dt * k1v, a2

    a3, _ = accel_fn(pos + 0.5 * dt * k2x)
    k3x, k3v = vel + 0.5 * dt * k2v, a3

    a4, _ = accel_fn(pos + dt * k3x)
    k4x, k4v = vel + dt * k3v, a4

    pos = pos + (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    vel = vel + (dt / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
    acc, pot = accel_fn(pos)
    return pos, vel, acc, pot


_INTEGRATORS = {
    "euler_semi_implicit": euler_semi_implicit,
    "euler": euler_explicit,
    "leapfrog": leapfrog_kdk,
    "dkd": leapfrog_dkd,
    "yoshida4": yoshida4,
    "rk4": rk4,
}


def get_integrator(name: str):
    try:
        return _INTEGRATORS[name]
    except KeyError:
        raise ValueError(f"unknown integrator {name!r}; options: {sorted(_INTEGRATORS)}")
