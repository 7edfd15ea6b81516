"""The sharded simulation step: the integrator on each rank's particle
shard, forces by the ring all-pairs schedule (parallel/ring.py), the
replicated-tree Barnes-Hut or the distributed Barnes-Hut
(parallel/distributed.py). Counterpart of
`parallelnbody_tpu/parallel/sharded.py`; every function here runs on one
rank, as the body of the JAX package's shard_map does, with the rank's
RingGroup in place of the mesh axis.
"""

from __future__ import annotations

import dataclasses

import torch

from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.ops.integrators import get_integrator
from parallelnbody_tpu_torch.parallel.mesh import RingGroup
from parallelnbody_tpu_torch.parallel.ring import ring_accel
from parallelnbody_tpu_torch.state import SimState


def _make_tile_fn(cfg: SimConfig, device):
    """The ring pass's tile: K3 for force="direct_pallas" (as resolved on
    the rank's device), else the plain tile (ring_accel's default)."""
    if cfg.resolve_force(device) == "direct_pallas":
        from parallelnbody_tpu_torch.ops.direct_kernels import \
            make_allpairs_tile_fn

        return make_allpairs_tile_fn(cfg)
    return None


def _bh_sharded_accel(pos_local, mass_local, cfg: SimConfig,
                      group: RingGroup, with_overflow: bool = False):
    """Replicated-tree Barnes-Hut: every rank gathers all (pos, mass),
    sorts and builds the whole tree, evaluates its ~1/P slice of target
    leaves (ops/bh.py bh_accel_target_slice, K1 unwindowed), gathers the
    slice results and takes the rows of its own particles through the
    replicated sort permutation. with_overflow=True also returns the
    list-budget overflow summed over ranks (overlapping trailing windows
    may count a clip twice; zero means zero)."""
    from parallelnbody_tpu_torch.ops.bh import (BHSetup,
                                                bh_accel_target_slice,
                                                slice_row_of_sorted)

    cfg = cfg.with_resolved_leaf(group.device)
    n_ranks, rank = group.world_size, group.rank
    n_local = pos_local.shape[0]
    both = group.all_gather(torch.cat([pos_local, mass_local[:, None]], 1))
    # The potential always, as the JAX package's slices compute it.
    setup = dataclasses.replace(BHSetup.of(cfg, both.shape[0]),
                                compute_pot=True)
    acc_sl, pot_sl, perm, overflow = bh_accel_target_slice(
        both[:, :3].contiguous(), both[:, 3].contiguous(), rank, n_ranks,
        setup)
    out_g = group.all_gather(torch.cat([acc_sl, pot_sl[:, None]], 1))
    inv_perm = torch.argsort(perm)  # sorted position of each original row
    my_ids = rank * n_local + torch.arange(n_local, device=perm.device)
    rows = slice_row_of_sorted(inv_perm[my_ids], setup.n_leaves, n_ranks,
                               setup.leaf)
    acc, pot = out_g[rows, :3], out_g[rows, 3]
    if with_overflow:
        return acc, pot, group.all_reduce(overflow.to(torch.int32))
    return acc, pot


def _accel_fn(cfg: SimConfig, group: RingGroup, mass, of_cell=None):
    """accel_fn(pos) -> (acc, pot) of the configured sharded force method;
    each evaluation's overflow (summed over ranks) is added to of_cell[0]
    where given."""
    method = cfg.resolve_force(group.device)
    if method == "barnes_hut" and cfg.bh_distributed:
        from parallelnbody_tpu_torch.parallel.distributed import dist_bh_accel

        def accel_fn(pos):
            acc, pot, of = dist_bh_accel(pos, mass, cfg, group)
            if of_cell is not None:
                of_cell[0] = of_cell[0] + of
            return acc, pot
    elif method == "barnes_hut":
        def accel_fn(pos):
            acc, pot, of = _bh_sharded_accel(pos, mass, cfg, group,
                                             with_overflow=True)
            if of_cell is not None:
                of_cell[0] = of_cell[0] + of
            return acc, pot
    else:
        tile_fn = _make_tile_fn(cfg, group.device)

        def accel_fn(pos):
            return ring_accel(pos, mass, g=cfg.g, softening=cfg.softening,
                              group=group, tile_fn=tile_fn)
    return accel_fn


def _zero(group):
    return torch.zeros((), dtype=torch.int32, device=group.device)


def make_sharded_step(cfg: SimConfig, group: RingGroup,
                      report_overflow: bool = False):
    """step(state) -> state for this rank's shard of the state.
    report_overflow=True: step(state) -> (state, overflow), the Barnes-Hut
    budget and exchange clip count over the step's force evaluations,
    summed over ranks (always zero for the ring all-pairs path)."""
    integrator = get_integrator(cfg.integrator)

    def step(state: SimState):
        of_cell = [_zero(group)]
        accel_fn = _accel_fn(cfg, group, state.mass, of_cell)
        dt = torch.as_tensor(cfg.dt, dtype=state.pos.dtype,
                             device=state.pos.device)
        pos, vel, acc, pot = integrator(accel_fn, state.pos, state.vel,
                                        state.acc, state.pot, dt)
        out = state._replace(pos=pos, vel=vel, acc=acc, pot=pot,
                             time=state.time + dt, step=state.step + 1)
        return (out, of_cell[0]) if report_overflow else out

    return step


def make_sharded_run(cfg: SimConfig, group: RingGroup, n_steps: int):
    """n_steps sharded steps in one call."""
    step = make_sharded_step(cfg, group)

    def run(state: SimState) -> SimState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return run


def sharded_bh_overflow(cfg: SimConfig, group: RingGroup,
                        state: SimState) -> int:
    """Barnes-Hut list-budget (and, distributed, exchange) overflow of one
    force evaluation of the sharded state, summed over ranks: the audit to
    run before a long sharded run. Zero means nothing was clipped."""
    if cfg.bh_distributed:
        from parallelnbody_tpu_torch.parallel.distributed import dist_bh_accel

        _, _, overflow = dist_bh_accel(state.pos, state.mass, cfg, group)
    else:
        _, _, overflow = _bh_sharded_accel(state.pos, state.mass, cfg, group,
                                           with_overflow=True)
    return int(overflow)


def _virialize_sharded(state: SimState, group: RingGroup) -> SimState:
    """api.virialize_state over the ranks: 2K = -W with K and W summed over
    every rank's particles."""
    sums = group.all_reduce(torch.stack([
        0.5 * torch.sum(state.mass * torch.sum(state.vel * state.vel, -1)),
        0.5 * torch.sum(state.mass * state.pot)]))
    ke, w = sums[0], sums[1]
    scale = torch.sqrt(torch.clamp(-w, min=1e-30)
                       / torch.clamp(2.0 * ke, min=1e-30))
    return state._replace(vel=state.vel * scale)


def sharded_init_accel(cfg: SimConfig, group: RingGroup,
                       state: SimState) -> SimState:
    """Fill acc/pot of this rank's shard of a fresh state (the potential is
    always computed here), and apply cfg.virialize to a step-0 state."""
    acc, pot = _accel_fn(cfg, group, state.mass)(state.pos)
    out = state._replace(acc=acc, pot=pot)
    if cfg.virialize and int(state.step) == 0:
        out = _virialize_sharded(out, group)
    return out


def sharded_diagnostics(state: SimState, group: RingGroup) -> dict:
    """ops/energy.diagnostics of the whole state from every rank's shard:
    sums and maxima reduced over ranks. Floats, the same on every rank."""
    m, v, p = state.mass, state.vel, state.pos
    sums = group.all_reduce(torch.cat([
        torch.stack([0.5 * torch.sum(m * torch.sum(v * v, -1)),
                     0.5 * torch.sum(m * state.pot)]),
        torch.sum(m[:, None] * v, 0),
        torch.sum(m[:, None] * torch.linalg.cross(p, v), 0)]))
    maxes = group.all_reduce(torch.stack([
        torch.max(torch.linalg.vector_norm(state.acc, dim=-1)),
        torch.max(torch.linalg.vector_norm(p, dim=-1))]), op="max")
    ke, pe = float(sums[0]), float(sums[1])
    return {"time": float(state.time), "step": float(state.step),
            "kinetic": ke, "potential": pe, "energy": ke + pe,
            "momentum_norm": float(torch.linalg.vector_norm(sums[2:5])),
            "angular_momentum_norm": float(
                torch.linalg.vector_norm(sums[5:8])),
            "max_accel": float(maxes[0]), "max_radius": float(maxes[1])}
