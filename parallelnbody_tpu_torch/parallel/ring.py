"""Ring all-pairs force schedule. Counterpart of
`parallelnbody_tpu/parallel/ring.py` (`ring_accel`).

Each of P ranks owns N/P bodies. The (position, mass) source tile rotates
around the ring (RingGroup.shift_start, the ppermute); every pass each rank
adds the partial accelerations of its resident targets against the
visiting tile, so after P passes every target has seen every source. The
next tile's rotation starts before the current tile is computed, so the
transfer can run under the tile's compute. On a card the tile is kernel K3
(ops/direct_kernels.make_allpairs_tile_fn) for force="direct_pallas", as the
JAX package takes its Pallas tile; the plain tile otherwise.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.ops.direct import direct_accel_tile


def ring_accel(pos, mass, *, g, softening, group, tile_fn=None):
    """Accelerations (n_local, 3) and potentials (n_local,) of this rank's
    targets pos (n_local, 3) against every rank's sources; mass (n_local,).
    tile_fn(pos_i, pos_j, mass_j) -> (acc, pot) replaces the plain tile.
    Passes are added in ring order, starting from zero as the JAX loop
    does."""
    if tile_fn is None:
        def tile_fn(pi, pj, mj):
            return direct_accel_tile(pi, pj, mj, g=g, softening=softening)

    src = torch.cat([pos, mass[:, None]], dim=1)
    acc = torch.zeros_like(pos)
    pot = torch.zeros_like(mass)
    for p in range(group.world_size):
        nxt = (group.shift_start(src) if p < group.world_size - 1 else None)
        a, ph = tile_fn(pos, src[:, :3].contiguous(),
                        src[:, 3].contiguous())
        acc = acc + a
        pot = pot + ph
        if nxt is not None:
            src = nxt.wait()
    return acc, pot
