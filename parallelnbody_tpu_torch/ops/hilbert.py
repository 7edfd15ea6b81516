"""Hilbert-curve encoding (Skilling's algorithm) on int32 tensors.
Counterpart of `parallelnbody_tpu/ops/hilbert.py`: on the same f32 positions
the keys equal the JAX keys bit for bit.

Algorithm: J. Skilling, "Programming the Hilbert curve" (AIP Conf. Proc. 707,
2004): a bit transform of the quantized coordinates followed by the same bit
interleave as Morton.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.ops.morton import (MORTON_BITS, _spread_bits_3,
                                                quantize)


def hilbert_encode(pos, center, half_extent, bits: int = MORTON_BITS):
    """Hilbert keys (N,) int32 in [0, 8^bits) for (N, 3) positions in the
    cube [center - half_extent, center + half_extent]^3; out-of-box points
    clamp."""
    q = quantize(pos, center, half_extent, bits)
    x0, x1, x2 = q[:, 0], q[:, 1], q[:, 2]

    # --- Skilling transform: coords -> transposed Hilbert bits ---
    # Inverse undo excess work
    qbit = 1 << (bits - 1)
    while qbit > 1:
        x0, x1, x2 = _skilling_round(x0, x1, x2, qbit, qbit - 1)
        qbit >>= 1

    # Gray encode
    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = torch.zeros_like(x0)
    qbit = 1 << (bits - 1)
    while qbit > 1:
        t = torch.where((x2 & qbit) != 0, t ^ (qbit - 1), t)
        qbit >>= 1
    x0, x1, x2 = x0 ^ t, x1 ^ t, x2 ^ t

    # Interleave transposed bits: axis 0 is the most significant of each group.
    return (_spread_bits_3(x0) << 2) | (_spread_bits_3(x1) << 1) | _spread_bits_3(x2)


def _skilling_round(x0, x1, x2, qbit, p):
    """One Q-round of Skilling's inverse-undo, without in-place aliasing."""
    # axis 0 (exchange with itself is a no-op, so only the invert branch acts)
    hi = (x0 & qbit) != 0
    x0 = torch.where(hi, x0 ^ p, x0)
    # axis 1
    hi = (x1 & qbit) != 0
    t = (x0 ^ x1) & p
    x0n = torch.where(hi, x0 ^ p, x0 ^ t)
    x1n = torch.where(hi, x1, x1 ^ t)
    x0, x1 = x0n, x1n
    # axis 2
    hi = (x2 & qbit) != 0
    t = (x0 ^ x2) & p
    x0n = torch.where(hi, x0 ^ p, x0 ^ t)
    x2n = torch.where(hi, x2, x2 ^ t)
    return x0n, x1n, x2n
