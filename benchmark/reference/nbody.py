"""Direct-sum accelerations and a leapfrog trajectory at sampled targets.

Every function computes in the dtype of the tensors it is given: float64
for the comparison that decides `correct`, a lower precision for the
control that has to fail it. Sums are streamed over blocks of sources so
that a block's temporaries stay near `PAIRS_PER_BLOCK` pairs.
"""

from __future__ import annotations

import torch

PAIRS_PER_BLOCK = 1 << 25


def accel_at(tgt, src, mass, *, g, softening, self_index=None):
    """Accelerations (k, 3) at the targets tgt (k, 3) from every source
    (src (N, 3), mass (N,)): g * sum_j m_j d / (|d|^2 + eps^2)^(3/2) with
    d = src_j - tgt. self_index (k,), where given, is each target's own row
    among the sources, which is left out; with softening 0 a coincident
    pair is left out as well."""
    k, n = tgt.shape[0], src.shape[0]
    eps2 = float(softening) ** 2
    acc = torch.zeros_like(tgt)
    cols = max(1, PAIRS_PER_BLOCK // max(k, 1))
    for j0 in range(0, n, cols):
        j1 = min(n, j0 + cols)
        d = src[None, j0:j1, :] - tgt[:, None, :]
        r2 = torch.sum(d * d, dim=-1) + eps2
        u = torch.rsqrt(r2)
        if softening == 0.0:
            u = torch.where(r2 > 0, u, torch.zeros_like(u))
        w = mass[None, j0:j1] * (u * u * u)
        if self_index is not None:
            cols_j = torch.arange(j0, j1, device=tgt.device)
            w = w.masked_fill(cols_j[None, :] == self_index[:, None], 0.0)
        acc = acc + torch.einsum("kc,kcd->kd", w, d)
    return g * acc


def leapfrog_at(pos0, vel0, mass, idx, *, steps, dt, g, softening):
    """The kick-drift-kick leapfrog of the targets `idx` over `steps` steps
    of dt from (pos0, vel0), every particle's state at the start. Each
    force is a direct sum over all particles, the target's own row left
    out; a source's position at time t is pos0 + t vel0. That straight
    line leaves out t^2 / 2 of the source's acceleration: at most 3.2e-7
    of a length unit after 8 steps of 1e-4 at |a| <= 1, which moves a
    target's force by about 1e-6 of itself at a softening of 0.01, three
    orders under what the comparison resolves.

    Returns (a0, x, v, a): the targets' acceleration at the start, and
    their position, velocity and acceleration after the steps."""
    x = pos0[idx]
    v = vel0[idx]
    kw = dict(g=g, softening=softening, self_index=idx)
    a0 = accel_at(x, pos0, mass, **kw)
    a = a0
    for s in range(1, steps + 1):
        v = v + (0.5 * dt) * a
        x = x + dt * v
        a = accel_at(x, pos0 + (s * dt) * vel0, mass, **kw)
        v = v + (0.5 * dt) * a
    return a0, x, v, a


def strided(n, k):
    """The k evenly strided rows of rms_force_error_sample."""
    k = min(k, n)
    return (torch.arange(k) * (n // max(k, 1))) % n


def rms_force_error_sample(pos, mass, acc, *, g, softening, k=4096,
                           idx=None):
    """Relative rms error of `acc` against the direct sum at `pos`, over k
    evenly strided targets (or the rows `idx`, where given):
    sqrt(mean |a - a_dir|^2) / sqrt(mean |a_dir|^2). The arithmetic of the
    program's utils/accuracy.rms_force_error_sample, run in the dtype given
    (float64 in the benchmark); a target meets itself at distance 0, where
    softening > 0 gives no force."""
    if idx is None:
        idx = strided(pos.shape[0], k)
    idx = idx.to(pos.device)
    a_dir = accel_at(pos[idx], pos, mass, g=g, softening=softening)
    num = torch.sqrt(torch.mean(torch.sum((acc[idx] - a_dir) ** 2, -1)))
    den = torch.sqrt(torch.mean(torch.sum(a_dir ** 2, -1)))
    return float(num / den)
