"""The all-pairs kernel K3 and the force functions built on it.

Counterpart of `parallelnbody_tpu/ops/pallas_direct.py`:

  * `allpairs` replaces `_allpairs_kernel` (pallas_direct.py:38, called
    through `allpairs_raw` :79), source csrc/allpairs.cu; `allpairs_plain`
    is its plain PyTorch version;
  * `allpairs_self` is the same sum where the targets are the sources
    (self-gravity): from N_SYM particles on the card it evaluates each
    unordered pair once and adds it to both particles (csrc/allpairs.cu's
    self-gravity form), below N_SYM and above N_SYM_MAX it runs the cross
    form that `allpairs` runs;
  * `allpairs_accel_tile` is `pallas_accel_tile` (:122);
  * `make_allpairs_accel` is `make_pallas_accel` (:149), through
    `allpairs_self`;
  * `make_allpairs_tile_fn` is `make_pallas_tile_fn` (:167), the tile
    function of the multi-device ring (parallel/ring.py).

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

from parallelnbody_tpu_torch.kernels.launch import (COUNTERS, check, launch,
                                                    on_cpu, ptr, query)
from parallelnbody_tpu_torch.utils.profiling import span

LAUNCHES = {"allpairs": 0}

# The self-gravity form's tile of particles (csrc/allpairs.cu SYM_TILE).
SYM_TILE = 2048
# The least N at which allpairs_self runs the self-gravity form: on the
# H100 (700 W) it ran faster than the cross form at every tile count from
# 18 (36864) to 40 and at 48-256 tiles, by 3-38%, but slower at 16 and 17
# (its time steps by whole tile pairs an SM: 0.75 against 0.52 ms at
# 32768); PERF.md §6 has the sweep.
N_SYM = 36864
# The most: its slots grow as N^2 / 256 bytes (1.10 GB at 524288, where
# it ran 93.2 against the cross form's 131.7 ms); above it the cross form
# runs, whose scratch grows as N.
N_SYM_MAX = 524288
# The most chunks a row of tiles is cut into (sym_chunks); each adds N
# float4 of slots.
MAX_CHUNKS = 8


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


def _cross(pos_i, pos_j, mass_j, softening, compute_pot):
    """The cross form's launch on CUDA tensors (see `allpairs`)."""
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
           ptr(pos_i), ptr(table), ptr(out), ptr(partial), n_i, n_j,
           n_split, float(softening) ** 2, int(softening == 0.0),
           int(bool(compute_pot)))
    return out


def allpairs(pos_i, pos_j, mass_j, *, softening, compute_pot=True):
    """K3: raw all-pairs sums (Ni, 4) of targets pos_i (Ni, 3) against
    sources pos_j (Nj, 3), mass_j (Nj,). CPU tensors run `allpairs_plain`;
    CUDA tensors launch the kernel (f32 only) on a packed (Nj, 4)
    [x, y, z, m] source table built here, with the sources cut into the
    ranges of `pnb_allpairs_splits` and their partial sums added in range
    order (csrc/allpairs.cu)."""
    with span("k3"):
        COUNTERS["k3.pairs"] += pos_i.shape[0] * pos_j.shape[0]
        if on_cpu(pos_i, pos_j, mass_j):
            return allpairs_plain(pos_i, pos_j, mass_j, softening=softening,
                                  compute_pot=compute_pot)
        return _cross(pos_i, pos_j, mass_j, softening, compute_pot)


def sym_tiles(n):
    """The self-gravity form's tiles of SYM_TILE particles for n."""
    return -(-n // SYM_TILE)


def sym_pairs(n):
    """The pair evaluations (one rsqrt each) the self-gravity form makes
    for n particles, padding included: SYM_TILE^2 for each of the nb
    diagonal tiles (ordered pairs, self pair included) and each of the
    nb (nb - 1) / 2 unordered pairs of distinct tiles (both orders)."""
    nb = sym_tiles(n)
    return SYM_TILE * SYM_TILE * (nb * (nb + 1) // 2)


def sym_chunks(n, sms):
    """The chunks (blocks) a row of the self-gravity form's tiles is cut
    into, for n particles on a card of `sms` SMs. Blocks run in no fixed
    order: of nb * chunks blocks an SM runs about ceil(nb chunks / sms), of
    ceil((nb // 2 + 1) / chunks) tile pairs each, one after another or two
    at once (one block an SM and two ran 2.67 and 2.74 tile pairs a ms on
    the H100 at N = 262144). The chunks minimise that product, the larger
    on a tie, at most MAX_CHUNKS (PERF.md §6: 2 and 3 chunks at N = 196608
    ran 17.9 ms where 4 ran 13.4)."""
    nb = sym_tiles(n)
    items = nb // 2 + 1
    return min(range(1, min(items, MAX_CHUNKS) + 1),
               key=lambda c: (-(-nb * c // sms) * -(-items // c), -c))


def allpairs_self(pos, mass, *, softening, compute_pot=True):
    """K3 for self-gravity: the raw sums (N, 4) of `allpairs(pos, pos,
    mass)`. CPU tensors run `allpairs_plain(pos, pos, mass)`. On CUDA
    tensors N alone picks the form: from N_SYM to N_SYM_MAX the
    self-gravity form (one launch of csrc/allpairs.cu's self-gravity
    `allpairs_kernel` on pos and mass as they are, and its combine: each
    unordered pair once, added to both particles, the sums kept in
    `sym_chunks` + nb / 2 slots of N float4 and added in slot order),
    else the cross form."""
    with span("k3"):
        n = pos.shape[0]
        COUNTERS["k3.pairs"] += n * n
        if on_cpu(pos, mass):
            return allpairs_plain(pos, pos, mass, softening=softening,
                                  compute_pot=compute_pot)
        if not N_SYM <= n <= N_SYM_MAX:
            return _cross(pos, pos, mass, softening, compute_pot)
        check("pos", pos, torch.float32, (n, 3))
        check("mass", mass, torch.float32, (n,))
        COUNTERS["k3.sym_pairs"] += sym_pairs(n)
        out = torch.empty((n, 4), dtype=torch.float32, device=pos.device)
        chunks = sym_chunks(n, torch.cuda.get_device_properties(
            pos.device).multi_processor_count)
        n_slots = chunks + sym_tiles(n) // 2
        slots = torch.empty((n_slots if n_slots > 1 else 0, n, 4),
                            dtype=torch.float32, device=pos.device)
        launch(LAUNCHES, "allpairs", "pnb_allpairs_self", ptr(pos),
               ptr(mass), ptr(out), ptr(slots), n, chunks,
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
    """accel_fn(pos) -> (acc, pot): self-gravity through K3
    (`allpairs_self`). With cfg.track_potential=False the potential is
    skipped (zeros); diagnostics recompute it on demand."""
    compute_pot = cfg.track_potential

    def accel_fn(pos):
        with span("force"):
            out = allpairs_self(pos, mass, softening=cfg.softening,
                                compute_pot=compute_pot)
            return cfg.g * out[:, :3], -cfg.g * out[:, 3]

    return accel_fn


def make_allpairs_tile_fn(cfg):
    """tile_fn(pos_i, pos_j, mass_j) -> (acc, pot): one ring pass of the
    multi-device all-pairs schedule through K3."""

    def tile_fn(pos_i, pos_j, mass_j):
        return allpairs_accel_tile(pos_i, pos_j, mass_j, g=cfg.g,
                                   softening=cfg.softening)

    return tile_fn
