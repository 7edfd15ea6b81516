"""Force-accuracy sampling. Counterpart of `parallelnbody_tpu/utils/accuracy.py`:
the relative rms force error of an approximate evaluation against an
O(k*N) direct sum over k sampled targets."""

from __future__ import annotations

import torch


def direct_accel_at(pos, mass, tgt, *, g, softening, chunk: int = 32768):
    """O(k*N) direct-sum accelerations at the k `tgt` positions from all
    (pos, mass) sources, streamed over source chunks. Self-interactions are
    killed by the r2 > 0 guard when softening == 0; with softening > 0 a
    target that is a source gets exactly zero force from itself."""
    eps2 = float(softening) ** 2
    acc = torch.zeros_like(tgt)
    for j0 in range(0, pos.shape[0], chunk):
        ps, ms = pos[j0:j0 + chunk], mass[j0:j0 + chunk]
        d = ps[None, :, :] - tgt[:, None, :]
        r2 = torch.sum(d * d, -1) + eps2
        u = torch.rsqrt(r2)
        if softening == 0.0:
            u = torch.where(r2 > 0, u, torch.zeros_like(u))
        w = ms[None, :] * u * u * u
        acc = acc + torch.einsum("kc,kcd->kd", w, d)
    return g * acc


def rms_force_error_sample(pos, mass, acc, *, g, softening,
                           k: int = 4096) -> float:
    """Relative rms error of `acc` (any approximate force evaluation,
    consistent with `pos`) vs the direct sum, over k evenly-strided sample
    targets: sqrt(mean |a - a_dir|^2) / sqrt(mean |a_dir|^2)."""
    n = pos.shape[0]
    k = min(k, n)
    idx = (torch.arange(k, device=pos.device) * (n // max(k, 1))) % n
    a_dir = direct_accel_at(pos, mass, pos[idx], g=g, softening=softening)
    a = acc[idx]
    num = torch.sqrt(torch.mean(torch.sum((a - a_dir) ** 2, -1)))
    den = torch.sqrt(torch.mean(torch.sum(a_dir ** 2, -1)))
    return float(num / den)
