"""Anisotropic (AABB-projected) node bounds in the MAC on one CUDA device:
the port of scripts/aniso_bounds_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.aniso_bounds_probe
        [--n 1048576] [--ic plummer] [--leaf 256]
        [--thetas 0.6 0.72 0.84] [--variants iso target both]
        [--stride 64] [--iters 3] [--device cuda] [--out FILE]

The shipped MAC is isotropic: MAC_SIZE_SCALE * r_node < theta * (d -
r_leaf), r_* bounding radii. Two direction-aware variants use per-node
AABBs (union-propagated up the pyramid) with the support evaluated toward
the partner's CoM:

  * target: r_leaf replaced by min(r_leaf, support_t(u)), rigorous;
  * both: r_node also replaced by min(r_node, support_s(-u)), a heuristic
    that only the measured rms can validate.

For each (variant, theta): the dense per-level acceptance masks
(`masks_for`, the script's own level loop, the MAC planes as the same f32
operations in the same order), the near tiles (accepted source leaves
summed over targets: each is a G x G tile of K1), the far entries, and the
rms force error on every --stride-th target leaf against the direct sum
(quadrupole far field: the shipped accuracy class).

Inputs are the script's: the --ic family's positions and masses of
`SimConfig(n, ic, softening=0.01, dt=1e-4, force="barnes_hut")` from its
seed, `bh._prepare` (Hilbert curve, quadrupoles). `eval_sampled` runs on
the port's kernels: the near part by K1 (`bh_kernels.near_field`) on the
sampled rows' near mask compacted to lists (`near_rates.compact_keys`), the far
part by K4 (`bh_kernels.far_gather`) on `bh._nodes_all` with every level's
mask compacted to node ids, the reference by K3
(`direct_kernels.allpairs_accel_tile`, the sampled targets against all
sources) in place of the script's chunked `direct_accel_at`. On the card
each of the three is held against its plain version on a few of the
sampled rows (rtol 2e-4 / atol 2e-5); the masks and the evaluation have
their events ms and busy ms (`measure.phase`). `--device cpu` (the tests)
runs the plain versions and times nothing. Every line is one JSON object
carrying the card's name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse

import torch

from parallelnbody_tpu_torch.ops import bh, bh_kernels, direct_kernels
from parallelnbody_tpu_torch.tools import measure, near_rates, staged_probe
from parallelnbody_tpu_torch.tools.near_rates import ATOL, RTOL
from parallelnbody_tpu_torch.utils.accuracy import direct_accel_at

MAC = bh.MAC_SIZE_SCALE
VARIANTS = ("iso", "target", "both")
HELD_ROWS = 4               # sampled target leaves held to the plain versions


def node_aabbs(pos_s, mass_s, leaf_size, tree):
    """Per-level (a, b) AABB half-extents about each node's CoM: a = hi -
    com >= 0, b = com - lo >= 0, both (n_k, 3). Built from the leaves'
    particle boxes, unioned up the pyramid (empty nodes: zero extent)."""
    n_leaves = tree.com[0].shape[0]
    p = pos_s.reshape(n_leaves, leaf_size, 3)
    occ = (mass_s.reshape(n_leaves, leaf_size) > 0)[..., None]
    lo = torch.amin(torch.where(occ, p, torch.inf), dim=1)
    hi = torch.amax(torch.where(occ, p, -torch.inf), dim=1)
    lo = torch.where(torch.isfinite(lo), lo, tree.com[0])
    hi = torch.where(torch.isfinite(hi), hi, tree.com[0])
    los, his = [lo], [hi]
    for k in range(1, tree.n_levels):
        bfac = los[-1].shape[0] // tree.com[k].shape[0]
        los.append(torch.amin(los[-1].reshape(-1, bfac, 3), dim=1))
        his.append(torch.amax(his[-1].reshape(-1, bfac, 3), dim=1))
    a = [torch.clamp(h - c, min=0.0) for h, c in zip(his, tree.com)]
    b = [torch.clamp(c - lo_k, min=0.0) for lo_k, c in zip(los, tree.com)]
    return a, b


def _support_plane(a, b, ux, uy, uz):
    """Directional support of nodes with half-extents a/b (n, 3) toward the
    per-pair unit direction planes ux/uy/uz (L, n):
    sum_c max(a_c u_c, -b_c u_c)."""
    s = torch.zeros_like(ux)
    for c, u in ((0, ux), (1, uy), (2, uz)):
        s = s + torch.maximum(a[:, c][None, :] * u, -b[:, c][None, :] * u)
    return s


def masks_for(tree, ext_a, ext_b, theta, variant):
    """Dense per-level acceptance masks under the MAC variant (iso, target
    or both): (far_masks indexed by level, near_mask (L, n_leaves))."""
    tgt_com, tgt_r = tree.com[0], tree.radius[0]
    ta, tb = ext_a[0], ext_b[0]
    n_tgt = tgt_com.shape[0]
    n_levels = tree.n_levels
    far_masks = [None] * n_levels
    active = torch.ones((n_tgt, tree.com[n_levels - 1].shape[0]),
                        dtype=torch.bool, device=tgt_com.device)

    def mac_plane(k):
        node_com, node_r = tree.com[k], tree.radius[k]
        d2 = torch.zeros((n_tgt, node_com.shape[0]), dtype=tgt_com.dtype,
                         device=tgt_com.device)
        ds = []
        for c in range(3):
            dc = node_com[:, c][None, :] - tgt_com[:, c][:, None]
            ds.append(dc)
            d2 = d2 + dc * dc
        d = torch.sqrt(d2)
        inv = 1.0 / torch.clamp(d, min=1e-30)
        ux, uy, uz = ds[0] * inv, ds[1] * inv, ds[2] * inv
        if variant == "iso":
            s_t = tgt_r[:, None] * torch.ones_like(d)
            size = node_r[None, :] * torch.ones_like(d)
        else:
            # the targets' support toward the node (+u), rows per target
            s_t = _support_plane(ta, tb, ux.T, uy.T, uz.T).T
            s_t = torch.minimum(s_t, tgt_r[:, None])
            if variant == "both":
                # the node's support toward the target (-u)
                s_s = _support_plane(ext_a[k], ext_b[k], -ux, -uy, -uz)
                size = torch.minimum(s_s, node_r[None, :])
            else:
                size = node_r[None, :] * torch.ones_like(d)
        return (MAC * size) < (theta * (d - s_t))

    for k in range(n_levels - 1, 1, -1):
        macp = mac_plane(k)
        far_masks[k] = active & macp
        branch = tree.com[k - 1].shape[0] // tree.com[k].shape[0]
        active = torch.repeat_interleave(active & ~macp, branch, dim=1)
    mac1 = mac_plane(1)
    far_masks[1] = active & mac1
    rej1 = active & ~mac1
    branch0 = tree.com[0].shape[0] // tree.com[1].shape[0]
    cand = torch.repeat_interleave(rej1, branch0, dim=1)
    mac0 = mac_plane(0)
    live_tgt = (tree.mass[0] > 0)[:, None]
    far_masks[0] = cand & mac0 & live_tgt
    near = cand & ~mac0 & live_tgt
    return far_masks, near


def sampled_lists(tree, far_masks, near, rows):
    """The sampled rows' near list (leaf ids) and far list (node ids over
    `bh._nodes_all`, every level's accepted nodes)."""
    widths = [c.shape[0] for c in tree.com]
    offs = bh._level_offsets(widths)
    n = rows.shape[0]
    far = torch.cat([torch.where(far_masks[k][rows],
                                 offs[k] + bh._iota(n, w, rows.device),
                                 bh.INT32_MAX)
                     for k, w in enumerate(widths)], dim=1)
    near_keys = torch.where(near[rows], bh._iota(n, widths[0], rows.device),
                            bh.INT32_MAX)
    return (*near_rates.compact_keys(near_keys),
            *near_rates.compact_keys(far))


def eval_sampled(tree, far_masks, near, pos_s, mass_s, leaf_size,
                 sample_stride, g, eps, held=False):
    """Barnes-Hut forces of every sample_stride-th target leaf from the
    dense masks (K4 over the quadrupole node table, K1 over the near
    leaves) against the direct sum (K3). Returns (rms, sampled
    particles, {kernel: max abs err against its plain version} when
    held)."""
    n_leaves = tree.com[0].shape[0]
    dev = pos_s.device
    rows = torch.arange(0, n_leaves, sample_stride, device=dev)
    p = pos_s.reshape(n_leaves, leaf_size, 3)
    tgt_leaves = p[rows].contiguous()
    tgt = tgt_leaves.reshape(-1, 3)
    near_idx, near_valid, far_idx, far_valid = sampled_lists(
        tree, far_masks, near, rows)
    nodes = bh._nodes_all(tree, pos_s.dtype)
    kw = dict(g=g, softening=eps, compute_pot=False)
    a_far, _ = bh_kernels.far_gather(tgt_leaves, nodes, far_idx, far_valid,
                                     **kw)
    a_near, _ = bh_kernels.near_field(pos_s, mass_s, tgt_leaves, near_idx,
                                      near_valid, **kw)
    acc = a_far + a_near
    a_dir, _ = direct_kernels.allpairs_accel_tile(tgt, pos_s, mass_s, g=g,
                                                  softening=eps,
                                                  compute_pot=False)
    num = torch.sqrt(torch.mean(torch.sum((acc - a_dir) ** 2, -1)))
    den = torch.sqrt(torch.mean(torch.sum(a_dir ** 2, -1)))
    errs = None
    if held:
        h = slice(0, HELD_ROWS)
        t = tgt_leaves[h]
        cut = slice(0, HELD_ROWS * leaf_size)
        errs = {
            "far_gather": measure.max_abs_err(
                "aniso K4", a_far[cut], bh_kernels.far_gather_plain(
                    t, nodes, far_idx[h], far_valid[h], **kw)[0], RTOL,
                ATOL),
            "near_field": measure.max_abs_err(
                "aniso K1", a_near[cut], bh_kernels.near_field_plain(
                    pos_s, mass_s, t, near_idx[h], near_valid[h], **kw)[0],
                RTOL, ATOL),
            "allpairs": measure.max_abs_err(
                "aniso K3", a_dir[cut], direct_accel_at(
                    pos_s, mass_s, t.reshape(-1, 3), g=g, softening=eps),
                RTOL, ATOL)}
    return float(num / den), int(rows.shape[0] * leaf_size), errs


def probe(pos, mass, args, out=None):
    """Every (variant, theta) on pos / mass (on their device); emits and
    returns the records."""
    dev = pos.device
    pos_s, mass_s, _, tree, _, _ = bh._prepare(
        pos, mass, leaf_size=args.leaf, curve="hilbert", multipole_order=2)
    ext_a, ext_b = node_aabbs(pos_s, mass_s, args.leaf, tree)
    n_leaves = int(tree.com[0].shape[0])
    base = {"tool": "aniso_bounds_probe", "card": measure.card_of(dev),
            "n": pos.shape[0], "ic": args.ic, "leaf": args.leaf,
            "n_leaves": n_leaves, "stride": args.stride}
    cuda = dev.type == "cuda"
    records = []
    for variant in args.variants:
        for theta in args.thetas:
            (far_masks, near), mask_t = measure.phase(
                lambda: masks_for(tree, ext_a, ext_b, theta, variant),
                args.iters, dev)
            near_tiles = int(torch.sum(near))
            far_leaf = int(torch.sum(far_masks[0]))
            far_up = sum(int(torch.sum(far_masks[k]))
                         for k in range(1, tree.n_levels))
            (rms, n_samp, _), eval_t = measure.phase(
                lambda: eval_sampled(tree, far_masks, near, pos_s, mass_s,
                                     args.leaf, args.stride, 1.0, 0.01),
                args.iters, dev)
            held = (eval_sampled(tree, far_masks, near, pos_s, mass_s,
                                 args.leaf, args.stride, 1.0, 0.01,
                                 held=True)[2] if cuda else None)
            rec = {**base, "variant": variant, "theta": theta,
                   "near_tiles": near_tiles,
                   "near_tiles_per_target": near_tiles / n_leaves,
                   "far_leaf_entries": far_leaf,
                   "far_upper_entries": far_up, "rms": rms,
                   "n_sampled": n_samp, "max_abs_err_plain": held,
                   "masks_ms": mask_t["ms"],
                   "masks_busy_ms": mask_t["busy_ms"],
                   "eval_ms": eval_t["ms"], "eval_busy_ms": eval_t["busy_ms"]}
            records.append(rec)
            measure.emit(rec, out)
            del far_masks, near
    return records


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--ic", default="plummer")
    ap.add_argument("--leaf", type=int, default=256)
    ap.add_argument("--thetas", type=float, nargs="+",
                    default=[0.6, 0.72, 0.84])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--stride", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    pos, mass = staged_probe.inputs(args, dev)
    return probe(pos, mass, args, out=args.out)


if __name__ == "__main__":
    main()
