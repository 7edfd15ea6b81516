"""The dense leaf-list build (`bh.leaf_interactions`) split into its
steps, beside the sparse pipeline that the JAX package replaced with it,
timed one by one on one CUDA device: the port of scripts/li_profile.py.

    python3 -m parallelnbody_tpu_torch.tools.li_profile [--n 1048576]
        [--leaf 256] [--iters 5] [--device cuda] [--out FILE]

Inputs are the script's (NEAR, FAR and THETA are its constants):
`init_simulation(SimConfig(n, ic="plummer", softening=0.01, dt=1e-4,
force="barnes_hut", theta, bh_leaf_size, bh_near_budget, bh_far_budget,
bh_multipole=2))`, then `bh._prepare` (Hilbert curve, quadrupoles) and
`bh.traverse` at theta.

The script's stages A-E, closures in its `main`, are the round-1 sparse
pipeline: the JAX package builds its lists through a dense leaf plane
instead, and so does the port. They are functions here, each timed on the
outputs of the one before it, as the alternative the dense build beat:

  A  `stage_a`  compact the rejected level-1 nodes into a per-target list
                of ceil((near + far) / branch) candidates;
  B  `stage_b`  expand them to their leaf children (the candidates);
  C  `stage_c`  the leaf MAC over the candidates, gathering the source
                leaves' centres and radii;
  D  `stage_d`  compact the rejected candidates into the near list;
  E  `stage_e`  compact the accepted ones into the far0 list;
     the raw row sort of the candidate ids.

Stage B also blanks the rows of zero-mass (padding) target leaves, as
`leaf_interactions` does; the script's inputs have none. Composed A -> E
the stages give `leaf_interactions`' lists and overflow exactly wherever
stage A clips nothing (its overflow is printed); the tool checks that and
raises on a difference.

The split of the build the port runs follows: the dense masks
(`bh._dense_leaf_masks`), the near compact and the far compact (the two
`bh._row_compact` calls of `leaf_interactions`), then the whole
`bh.leaf_interactions` beside the sums of A-E and of the dense steps.

Each stage gets its events ms and busy ms (`measure.phase`: the mean of
--iters calls after a warm-up by CUDA events, and the kernels and copies
of one more call from torch.profiler). `--device cpu` (the tests) runs the
stages and times nothing. Every line is one JSON object carrying the
card's name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure

NEAR, FAR, THETA = 512, 2048, 0.7
SPARSE = ("A l1-compact", "B expand", "C mac gathers", "D near-compact",
          "E far-compact")
DENSE = ("dense masks", "dense near-compact", "dense far-compact")


def stage_a(rejects_l1, l1_budget):
    """A: the rejected level-1 nodes of each target, front-packed into
    l1_budget slots -> (idx1, valid1, overflow)."""
    cols = bh._iota(*rejects_l1.shape, rejects_l1.device)
    return bh._row_compact(rejects_l1, cols, l1_budget)


def stage_b(idx1, valid1, branch, tgt_mass):
    """B: each candidate node's `branch` leaf children -> (cand, cand_valid)
    (n_leaves, l1_budget * branch), ascending where idx1 is; rows of
    zero-mass targets left empty."""
    n = idx1.shape[0]
    cand = (idx1[:, :, None] * branch + torch.arange(
        branch, dtype=torch.int32, device=idx1.device)).reshape(n, -1)
    cand_valid = valid1.repeat_interleave(branch, dim=1)
    return cand, cand_valid & (tgt_mass > 0)[:, None]


def stage_c(tree, cand, theta):
    """C: the leaf MAC of each target against each candidate leaf, the
    distance summed component by component as `leaf_interactions` sums
    it -> (n_leaves, n_cand) bool, True where the leaf is accepted."""
    leaf_com, leaf_r = tree.com[0], tree.radius[0]
    c = cand.long()
    d2 = torch.zeros(cand.shape, dtype=leaf_com.dtype, device=cand.device)
    for k in range(3):
        dc = leaf_com[:, k][c] - leaf_com[:, k][:, None]
        d2 = d2 + dc * dc
    d = torch.sqrt(d2)
    return (bh.MAC_SIZE_SCALE * leaf_r[c]) < (theta * (d - leaf_r[:, None]))


def stage_d(cand, cand_valid, mac0, near_budget):
    """D: the near list -> (idx, valid, overflow)."""
    return bh._row_compact(cand_valid & ~mac0, cand, near_budget)


def stage_e(cand, cand_valid, mac0, far_budget):
    """E: the far0 list -> (idx, valid, overflow)."""
    return bh._row_compact(cand_valid & mac0, cand, far_budget)


def raw_sort(cand, cand_valid):
    """The row sort alone, on the candidate ids (INT32_MAX where empty)."""
    keys = torch.where(cand_valid, cand, bh.INT32_MAX)
    return torch.sort(keys, dim=1).values


def profile(tree, rejects_l1, *, theta, near, far, iters=5, out=None,
            base=None):
    """Times the stages on (tree, rejects_l1) on their device; checks the
    composed lists of A-E and of the dense steps against
    `bh.leaf_interactions`; emits the records (one a stage, then the whole
    and the check). Returns (records, A-E composed: (near_idx, near_valid,
    far0_idx, far0_valid, overflow))."""
    dev = rejects_l1.device
    n_leaves = tree.com[0].shape[0]
    branch = n_leaves // tree.com[1].shape[0]
    l1_budget = -(-(near + far) // branch)
    base = {"tool": "li_profile", "card": measure.card_of(dev),
            **(base or {})}
    records = []

    def run(name, fn, **info):
        got, times = measure.phase(fn, iters, dev)
        rec = {**base, "stage": name, **times, **info}
        measure.emit(rec, out)
        records.append(rec)
        return got

    idx1, valid1, of1 = run("A l1-compact", lambda: stage_a(rejects_l1,
                                                            l1_budget),
                            shape=list(rejects_l1.shape), budget=l1_budget)
    cand, cand_valid = run("B expand", lambda: stage_b(
        idx1, valid1, branch, tree.mass[0]), shape=[n_leaves,
                                                    l1_budget * branch])
    mac0 = run("C mac gathers", lambda: stage_c(tree, cand, theta))
    near_l = run("D near-compact", lambda: stage_d(cand, cand_valid, mac0,
                                                   near), budget=near)
    far_l = run("E far-compact", lambda: stage_e(cand, cand_valid, mac0,
                                                 far), budget=far)
    run("raw row sort", lambda: raw_sort(cand, cand_valid))
    del cand, cand_valid, mac0
    masks = run("dense masks", lambda: bh._dense_leaf_masks(
        tree, rejects_l1, theta, 0, n_leaves))
    cols = bh._iota(n_leaves, n_leaves, dev)
    dense_near = run("dense near-compact", lambda: bh._row_compact(
        masks[0], cols, near), budget=near)
    dense_far = run("dense far-compact", lambda: bh._row_compact(
        masks[1], cols, far), budget=far)
    del masks, cols
    whole = run("leaf_interactions", lambda: bh.leaf_interactions(
        tree, rejects_l1, theta, start_leaf=0, n_slice=n_leaves,
        near_budget=near, far0_budget=far))
    composed = (*near_l[:2], *far_l[:2], near_l[2] + far_l[2])
    dense = (*dense_near[:2], *dense_far[:2], dense_near[2] + dense_far[2])
    equal = all(torch.equal(a, b) for a, b in zip(composed, whole))
    if not all(torch.equal(a, b) for a, b in zip(dense, whole)):
        raise AssertionError("the dense steps composed differ from "
                             "leaf_interactions")

    def total(names):
        ms = [r["ms"] for r in records if r["stage"] in names]
        return None if None in ms else sum(ms)

    rec = {**base, "summary": True, "a_to_e_ms": total(SPARSE),
           "dense_ms": total(DENSE),
           "leaf_interactions_ms": records[-1]["ms"],
           "l1_overflow": int(of1), "overflow": int(whole[4]),
           "lists_equal": equal}
    measure.emit(rec, out)
    records.append(rec)
    if not equal and int(of1) == 0:
        raise AssertionError("stages A-E composed differ from "
                             "leaf_interactions with nothing clipped in A")
    return records, composed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    cfg = SimConfig(n=args.n, ic="plummer", softening=0.01, dt=1e-4,
                    force="barnes_hut", theta=THETA,
                    bh_leaf_size=args.leaf, bh_near_budget=NEAR,
                    bh_far_budget=FAR, bh_multipole=2)
    state = init_simulation(cfg, dev, compute_forces=False)
    tree = bh._prepare(state.pos, state.mass, leaf_size=args.leaf,
                       curve="hilbert", multipole_order=2)[3]
    del state
    _, rejects_l1 = bh.traverse(tree, THETA)
    return profile(tree, rejects_l1, theta=THETA, near=NEAR, far=FAR,
                   iters=args.iters, out=args.out,
                   base={"n": args.n, "leaf": args.leaf})[0]


if __name__ == "__main__":
    main()
