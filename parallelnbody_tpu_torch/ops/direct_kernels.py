"""The all-pairs kernel K3 and the force functions built on it.

Counterpart of `parallelnbody_tpu/ops/pallas_direct.py`:

  * `allpairs` replaces `_allpairs_kernel` (pallas_direct.py:38, called
    through `allpairs_raw` :79), source csrc/allpairs.cu; `allpairs_plain`
    is its plain PyTorch version;
  * `allpairs_accel_tile` is `pallas_accel_tile` (:122);
  * `make_allpairs_accel` is `make_pallas_accel` (:149);
  * `make_allpairs_tile_fn` is `make_pallas_tile_fn` (:167), the tile
    function of the multi-device ring (not ported yet).

The kernel returns raw sums (Ni, 4) = [sum w dx, sum w dy, sum w dz,
sum m u] of targets against sources, with u = rsqrt(r^2 + eps^2) and
w = m u^3; guard_zero (softening 0) zeroes u where r^2 = 0, and
compute_pot=False leaves the last column 0. `allpairs_accel_tile` scales by
g and negates the last column into the potential.

The wrapper dispatches on the device of its tensors as the Barnes-Hut
kernels do (kernels/launch.py): CPU tensors run `allpairs_plain`, CUDA
tensors launch the kernel or raise. `LAUNCHES` counts kernel launches. The
config fields tile_i / tile_j shape the JAX package's Pallas grid only; the
port ignores them.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.kernels.launch import (check, launch, on_cpu, ptr,
                                                    query)

LAUNCHES = {"allpairs": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Element budget of one plain-version (target rows x sources) plane: bounds
# its memory at N = 262144 (128 target rows, ~0.4 GB per (.., 3) temporary).
_PLAIN_BLOCK_ELEMS = 1 << 25


def allpairs_plain(pos_i, pos_j, mass_j, *, softening, compute_pot=True):
    """Raw all-pairs sums (plain torch) of targets pos_i (Ni, 3) against
    sources pos_j (Nj, 3), mass_j (Nj,), streamed over blocks of target
    rows. Returns (Ni, 4) [sum w dx, sum w dy, sum w dz, sum m u]."""
    n_j = pos_j.shape[0]
    eps2 = float(softening) ** 2
    out = pos_i.new_zeros((pos_i.shape[0], 4))
    rows = max(1, _PLAIN_BLOCK_ELEMS // max(n_j, 1))
    for i0 in range(0, pos_i.shape[0], rows):
        d = pos_j[None, :, :] - pos_i[i0:i0 + rows, None, :]  # (R, Nj, 3)
        r2 = torch.sum(d * d, dim=-1) + eps2
        u = torch.rsqrt(r2)
        if softening == 0.0:
            u = torch.where(r2 > 0, u, torch.zeros_like(u))
        mu = mass_j[None, :] * u
        w = mu * (u * u)
        out[i0:i0 + rows, :3] = torch.einsum("ij,ijc->ic", w, d)
        if compute_pot:
            out[i0:i0 + rows, 3] = torch.sum(mu, dim=1)
    return out


def allpairs(pos_i, pos_j, mass_j, *, softening, compute_pot=True):
    """K3: raw all-pairs sums (Ni, 4) of targets pos_i (Ni, 3) against
    sources pos_j (Nj, 3), mass_j (Nj,). CPU tensors run `allpairs_plain`;
    CUDA tensors launch the kernel (f32 only) on a packed (Nj, 4)
    [x, y, z, m] source table built here, with the sources cut into the
    ranges of `pnb_allpairs_splits` and their partial sums added in range
    order (csrc/allpairs.cu)."""
    if on_cpu(pos_i, pos_j, mass_j):
        return allpairs_plain(pos_i, pos_j, mass_j, softening=softening,
                              compute_pot=compute_pot)
    n_i, n_j = pos_i.shape[0], pos_j.shape[0]
    check("pos_i", pos_i, torch.float32, (n_i, 3))
    check("pos_j", pos_j, torch.float32, (n_j, 3))
    check("mass_j", mass_j, torch.float32, (n_j,))
    dev = pos_i.device
    table = torch.cat([pos_j, mass_j[:, None]], dim=1)
    out = torch.empty((n_i, 4), dtype=torch.float32, device=dev)
    n_split = query("pnb_allpairs_splits", n_i, n_j) if n_i else 1
    partial = torch.empty((n_split if n_split > 1 else 0, n_i, 4),
                          dtype=torch.float32, device=dev)
    launch(LAUNCHES, "allpairs", "pnb_allpairs",
           ptr(pos_i), ptr(table), ptr(out), ptr(partial), n_i, n_j, n_split,
           float(softening) ** 2, int(softening == 0.0),
           int(bool(compute_pot)))
    return out


def allpairs_accel_tile(pos_i, pos_j, mass_j, *, g, softening,
                        compute_pot=True):
    """Accelerations (Ni, 3) and potentials (Ni,) of targets pos_i against
    sources (pos_j, mass_j) through K3 (`pallas_accel_tile`)."""
    out = allpairs(pos_i, pos_j, mass_j, softening=softening,
                   compute_pot=compute_pot)
    return g * out[:, :3], -g * out[:, 3]


def make_allpairs_accel(cfg, mass):
    """accel_fn(pos) -> (acc, pot): self-gravity through K3. With
    cfg.track_potential=False the potential is skipped (zeros);
    diagnostics recompute it on demand."""
    compute_pot = cfg.track_potential

    def accel_fn(pos):
        return allpairs_accel_tile(pos, pos, mass, g=cfg.g,
                                   softening=cfg.softening,
                                   compute_pot=compute_pot)

    return accel_fn


def make_allpairs_tile_fn(cfg):
    """tile_fn(pos_i, pos_j, mass_j) -> (acc, pot): one ring pass of the
    multi-device all-pairs schedule through K3."""

    def tile_fn(pos_i, pos_j, mass_j):
        return allpairs_accel_tile(pos_i, pos_j, mass_j, g=cfg.g,
                                   softening=cfg.softening)

    return tile_fn
