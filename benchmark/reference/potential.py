"""The direct-sum potential at sampled targets.

Computes in the dtype of the tensors it is given, as `nbody.accel_at`
does, and is softened and streamed over blocks of sources the same way.
"""

from __future__ import annotations

import torch

from benchmark.reference.nbody import PAIRS_PER_BLOCK


def potential_at(tgt, src, mass, *, g, softening, self_index=None):
    """Potentials (k,) at the targets tgt (k, 3) from every source (src
    (N, 3), mass (N,)): -g * sum_j m_j / (|d|^2 + eps^2)^(1/2) with d =
    src_j - tgt. self_index (k,), where given, is each target's own row
    among the sources, which is left out; with softening 0 a coincident
    pair is left out as well. Without self_index a target that is a source
    meets itself at distance 0, which adds the constant -g m_i / eps: the
    convention of the program's potential (its ops/energy.py)."""
    k, n = tgt.shape[0], src.shape[0]
    eps2 = float(softening) ** 2
    pot = tgt.new_zeros((k,))
    cols = max(1, PAIRS_PER_BLOCK // max(k, 1))
    for j0 in range(0, n, cols):
        j1 = min(n, j0 + cols)
        d = src[None, j0:j1, :] - tgt[:, None, :]
        r2 = torch.sum(d * d, dim=-1) + eps2
        u = torch.rsqrt(r2)
        if softening == 0.0:
            u = torch.where(r2 > 0, u, torch.zeros_like(u))
        w = mass[None, j0:j1] * u
        if self_index is not None:
            cols_j = torch.arange(j0, j1, device=tgt.device)
            w = w.masked_fill(cols_j[None, :] == self_index[:, None], 0.0)
        pot = pot - torch.sum(w, dim=1)
    return g * pot
