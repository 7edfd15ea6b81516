"""Rank programs for the launcher (mesh.RankPool / mesh.launch): each takes
the rank's RingGroup first and returns what the caller needs from that rank
as plain data (tensors come back as numpy). They live here, in a module
without JAX, because the spawned ranks import the module of the function
they run.

    sharded(group, cfg_json, arrays, program, ...)   one sharded entry point
                                                     on the rank's shard
    owned_geometry(group, cfg_json, arrays, ...)     a distributed
                                                     evaluation's integer
                                                     outputs (ownership,
                                                     lists, LET plan)
    ring_neighbour(group)                            the rank a ring shift
                                                     brings this rank's
                                                     value from

`arrays` is a full state as numpy arrays (state.state_to_numpy), every rank
taking its rows; None makes every rank draw the config's ICs itself.
"""

from __future__ import annotations

import torch

from parallelnbody_tpu_torch.config import SimConfig
from parallelnbody_tpu_torch.parallel import distributed as D
from parallelnbody_tpu_torch.parallel import mesh, sharded as S
from parallelnbody_tpu_torch.state import state_from_numpy, torch_dtype


def local_state(group, cfg: SimConfig, arrays):
    """This rank's shard of `arrays` (or of the config's ICs)."""
    if arrays is None:
        from parallelnbody_tpu_torch.api import init_simulation

        full = init_simulation(cfg, "cpu", compute_forces=False)
    else:
        full = state_from_numpy(arrays, "cpu", torch_dtype(cfg.dtype))
    return mesh.shard_state(full, group)


def ring_neighbour(group):
    """(rank, world size, the rank whose value one ring shift brings
    here): the ring order of a rank pool."""
    got = group.shift_start(torch.tensor([group.rank],
                                         device=group.device)).wait()
    return group.rank, group.world_size, int(got[0])


def sharded(group, cfg_json, arrays, program, n_steps=1,
            debug_exchange=False):
    """Run one entry point on this rank's shard and return {"state": the
    rank's rows as numpy (time and step included), "overflow": int,
    "migrants": list} (keys as the program gives them). Programs: "init"
    (sharded_init_accel), "step" (make_sharded_step n_steps times,
    reporting overflow), "run" (make_sharded_run), "distributed"
    (make_distributed_run), "overflow" (sharded_bh_overflow),
    "dist_accel" (dist_bh_accel, state acc/pot filled)."""
    cfg = SimConfig.from_json(cfg_json)
    state = local_state(group, cfg, arrays)
    out = {}
    if program == "init":
        state = S.sharded_init_accel(cfg, group, state)
    elif program == "step":
        step = S.make_sharded_step(cfg, group, report_overflow=True)
        total = 0
        for _ in range(n_steps):
            state, of = step(state)
            total += int(of)
        out["overflow"] = total
    elif program == "run":
        state = S.make_sharded_run(cfg, group, n_steps)(state)
    elif program == "distributed":
        res = D.make_distributed_run(cfg, group, n_steps,
                                     debug_exchange=debug_exchange)(state)
        state, out["overflow"] = res[0], int(res[1])
        if debug_exchange:
            out["migrants"] = res[2].tolist()
    elif program == "overflow":
        out["overflow"] = S.sharded_bh_overflow(cfg, group, state)
        return out
    elif program == "dist_accel":
        acc, pot, of = D.dist_bh_accel(state.pos, state.mass, cfg, group)
        state = state._replace(acc=acc, pot=pot)
        out["overflow"] = int(of)
    else:
        raise ValueError(f"unknown program {program!r}")
    out["state"] = mesh.numpy_state(state)
    return out


def owned_geometry(group, cfg_json, arrays, with_sources=False):
    """One distributed evaluation's integer outputs on this rank: the
    repartition's ownership (id_own, valid_own, migrants, exchange
    overflow), the near and far lists of the rank's target leaves and their
    overflow, and the LET plan's remapped lists and overflow. With
    with_sources, every rank adds its owned particles as a packed
    (own_cap, 4) [x, y, z, m] table and rank 0 its target leaves and
    assembled LET source table (the inputs of K1's window and table
    forms)."""
    cfg = SimConfig.from_json(cfg_json).with_resolved_leaf(group.device)
    state = local_state(group, cfg, arrays)
    n_local = state.n
    leaf = cfg.resolve_bh_leaf_size()
    cap_pair, own_cap, n_leaf_loc = D._plan_cfg(cfg, n_local,
                                                group.world_size, leaf)
    ids = group.rank * n_local + torch.arange(n_local, dtype=torch.int32,
                                              device=group.device)
    valid = torch.ones((n_local,), dtype=torch.bool, device=group.device)
    pos_own, _, mass_own, id_own, valid_own, sentinel, of_ex, mig = \
        D._repartition(state.pos, [], state.mass, ids, valid, group=group,
                       cap_pair=cap_pair, own_cap=own_cap, n_live=n_local,
                       curve=cfg.bh_curve)
    tree = D._owned_tree(pos_own, mass_own, sentinel, cfg, leaf_size=leaf,
                         group=group)
    setup, ni, nv, far, of_lists = D._lists(
        tree, cfg, start=group.rank * n_leaf_loc, n_leaf_loc=n_leaf_loc)
    lp = D._near_let_plan(ni, nv, cfg, group=group, n_leaf_loc=n_leaf_loc)
    out = {"id_own": id_own, "valid_own": valid_own,
           "migrants": int(mig), "of_exchange": int(of_ex),
           "near_idx": ni, "near_valid": nv, "far_idx": far[0],
           "far_valid": far[1], "of_lists": int(of_lists),
           "let_new_idx": lp.new_idx, "let_overflow": int(lp.overflow),
           "refine": setup.refine, "far_mode": setup.far_mode,
           "n_leaf_loc": n_leaf_loc,
           "sentinel": sentinel}
    if with_sources:
        packed = torch.cat([pos_own, mass_own[:, None]], 1)
        out["sources"] = packed
        table = D._let_table(pos_own, mass_own, lp, cfg, group=group,
                             leaf_size=leaf, n_leaf_loc=n_leaf_loc)
        if group.rank == 0:
            out["tgt"] = pos_own.reshape(n_leaf_loc, leaf, 3)
            out["let_table"] = table
    return out
