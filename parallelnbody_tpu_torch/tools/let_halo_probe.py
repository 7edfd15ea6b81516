"""The locally essential halo behind bh_comm="let": the port of
scripts/let_halo_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.let_halo_probe [--n 262144]
        [--ranks 8] [--theta 0.72] [--leaf 0] [--device cuda] [--out FILE]

The LET near field imports only the source leaf tiles that a rank's near
lists name; its traffic an evaluation is that halo, against the ring's P -
1 full-shard shifts. The probe measures the halo exactly without ranks: it
sorts the whole tree on one device (`bh._prepare`, the distributed leaf
structure but for each rank's padding), builds the near lists of each
contiguous rank window of target leaves with the builders the distributed
path calls with `start_leaf` / `n_slice` (`bh.traverse`, then
`build_interaction_lists` or `build_interaction_lists_staged`, octet far
field), and reports per rank the leaves it needs (own and imported), its
imports and the most it imports from one owner (what bh_import_budget must
cover). The case line adds the worst rank's fractions of the global leaf
count and the bytes an evaluation: LET, the worst rank's imports x one
leaf tile of 16 B a particle (the port's table is packed (n_rows * G, 4)
f32, the same 16 B a particle as JAX's (4, G) tiles); ring, (P - 1) x N / P
particles x 16 B.

The script's three ICs (Plummer, galaxy_collision, disk) at its shape:
theta 0.72, near budget 3584, far budget 2816 (frozen: every case prints
its overflow), softening 0.01. `--leaf 0` resolves the leaf by the run's
device (`SimConfig.resolve_bh_leaf_size`): 128 at N = 262144 on both the
card and the CPU, while at 1M the card's rule gives 128 and the CPU's
(the JAX package's) 256; the line prints the leaf used. The builders
launch no kernel. `--device cpu` for the tests.
"""

from __future__ import annotations

import argparse

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure

TILE_BYTES_PER_PARTICLE = 16   # x, y, z, m in f32


def rank_near_lists(tree, theta, refine, cands, start, n_slice, *,
                    near_budget, far_budget, dtype):
    """The near lists (idx, valid) of target leaves [start, start +
    n_slice), as the distributed path builds them, and their overflow."""
    if refine == "staged":
        far_masks, rej2 = bh.traverse(tree, theta, start_leaf=start,
                                      n_slice=n_slice, stop_level=2)
        out = bh.build_interaction_lists_staged(
            tree, far_masks, rej2, theta=theta, start_leaf=start,
            n_slice=n_slice, near_budget=near_budget, far_budget=far_budget,
            cand2_budget=cands[0], cand1_budget=cands[1], dtype=dtype,
            octet_far=True)
    else:
        far_masks, rej1 = bh.traverse(tree, theta, start_leaf=start,
                                      n_slice=n_slice)
        out = bh.build_interaction_lists(
            tree, far_masks, rej1, theta=theta, start_leaf=start,
            n_slice=n_slice, near_budget=near_budget, far0_budget=far_budget,
            dtype=dtype)
    return out[0], out[1], out[-1]


def run_case(name, cfg, n_ranks, device, state=None, out=None):
    """One IC's case: per-rank halo counts and the case line. `state`
    (with pos and mass on device) holds the particles, else the config's
    own ICs."""
    if state is None:
        state = init_simulation(cfg, device, compute_forces=False)
    leaf = cfg.resolve_bh_leaf_size(device)
    _, _, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    l_glob = n_pad // leaf
    n_leaf_loc = -(-l_glob // n_ranks)
    refine, cands = bh.resolve_refine(
        cfg.resolve_bh_refine(device),
        (cfg.bh_cand2_budget, cfg.bh_cand_budget), tree.n_levels,
        cfg.bh_near_budget, cfg.bh_far_budget)
    owner = torch.arange(l_glob, device=state.pos.device) // n_leaf_loc
    per_rank, overflow = [], 0
    for r in range(n_ranks):
        start = r * n_leaf_loc
        ns = min(n_leaf_loc, l_glob - start)
        if ns <= 0:
            break
        idx, valid, of = rank_near_lists(
            tree, cfg.theta, refine, cands, start, ns,
            near_budget=cfg.bh_near_budget, far_budget=cfg.bh_far_budget,
            dtype=state.pos.dtype)
        overflow += int(of)
        needed = torch.zeros(l_glob, dtype=torch.bool, device=owner.device)
        needed[idx[valid].long()] = True
        by_owner = torch.bincount(owner[needed], minlength=n_ranks)
        by_owner[r] = 0
        per_rank.append({"rank": r, "needed": int(needed.sum()),
                         "imports": int(by_owner.sum()),
                         "max_pair": (int(by_owner.max()) if n_ranks > 1
                                      else 0)})
    max_imports = max(p["imports"] for p in per_rank)
    max_pair = max(p["max_pair"] for p in per_rank)
    rec = {"tool": "let_halo_probe", "card": measure.card_of(device),
           "case": name, "n": cfg.n, "ranks": n_ranks, "leaf": leaf,
           "l_glob": l_glob, "n_leaf_loc": n_leaf_loc, "refine": refine,
           "theta": cfg.theta, "overflow": overflow, "per_rank": per_rank,
           "max_needed_frac": max(p["needed"] for p in per_rank) / l_glob,
           "max_import_frac": max_imports / l_glob,
           "max_pair_leaves": max_pair,
           "pair_budget_frac_of_auto": max_pair / n_leaf_loc,
           "let_bytes_per_eval": max_imports * leaf * TILE_BYTES_PER_PARTICLE,
           "ring_bytes_per_eval": ((n_ranks - 1) * (n_pad // n_ranks)
                                   * TILE_BYTES_PER_PARTICLE)}
    measure.emit(rec, out)
    return rec


def cases(n, theta, leaf):
    """The script's three (name, config) cases."""
    common = dict(n=n, force="barnes_hut", theta=theta, softening=0.01,
                  bh_leaf_size=leaf, bh_near_budget=3584,
                  bh_far_budget=2816)
    return [(ic, SimConfig(ic=ic, **common))
            for ic in ("plummer", "galaxy_collision", "disk")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--leaf", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    return [run_case(name, cfg, args.ranks, dev, out=args.out)
            for name, cfg in cases(args.n, args.theta, args.leaf)]


if __name__ == "__main__":
    main()
