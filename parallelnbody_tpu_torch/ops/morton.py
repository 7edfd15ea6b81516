"""Morton (Z-order) encoding on int32 tensors. Counterpart of
`parallelnbody_tpu/ops/morton.py`: on the same f32 positions the keys equal
the JAX keys bit for bit.

Quantize each coordinate to `bits` levels and interleave the bits, so the
key's 3-bit groups are the octant indices from root to leaf (X is the most
significant bit of each group, the reference's convention,
OctreeSearch.h:52-54). Keys are 3*bits <= 30 bits in int32.
"""

from __future__ import annotations

import torch

MORTON_BITS = 10  # 10 bits/axis -> 30-bit keys, tree depth 10


def _spread_bits_3(v):
    """Insert two zero bits between each of the low 10 bits of v (int32)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def quantize(pos, center, half_extent, bits: int = MORTON_BITS):
    """(N, 3) int32 cell coordinates of positions in the cube
    [center - half_extent, center + half_extent]^3; points outside clamp."""
    n_cells = 1 << bits
    scale = n_cells / (2.0 * half_extent)
    q = torch.floor((pos - (center - half_extent)) * scale).to(torch.int32)
    return torch.clamp(q, 0, n_cells - 1)


def morton_encode(pos, center, half_extent, bits: int = MORTON_BITS):
    """Morton keys (N,) int32 for (N, 3) positions."""
    q = quantize(pos, center, half_extent, bits)
    ex = _spread_bits_3(q[:, 0])
    ey = _spread_bits_3(q[:, 1])
    ez = _spread_bits_3(q[:, 2])
    return (ex << 2) | (ey << 1) | ez


def morton_decode(key, bits: int = MORTON_BITS):
    """Inverse of the bit interleave: (N,) int32 keys -> (N, 3) int32
    cells."""
    def compact(v):
        v = v & 0x09249249
        v = (v | (v >> 2)) & 0x030C30C3
        v = (v | (v >> 4)) & 0x0300F00F
        v = (v | (v >> 8)) & 0x030000FF
        v = (v | (v >> 16)) & 0x3FF
        return v

    return torch.stack([compact(key >> 2), compact(key >> 1), compact(key)],
                       dim=-1)
