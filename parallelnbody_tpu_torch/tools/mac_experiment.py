"""Moment-based MAC experiment (falcON-style) on one CUDA device: the port
of scripts/mac_experiment.py.

    python3 -m parallelnbody_tpu_torch.tools.mac_experiment
        [--leaf 256] [--near 3584] [--far 1536] [--theta 0.72]
        [--n-rms 262144] [--n 1048576] [--iters 5] [--device cuda]
        [--out FILE]

The group MAC's source size is the node's bounding radius; fat sparse
leaves have r_max >> r_rms. This tool replaces it by k * r_rms (the
mass-weighted rms member distance, propagated up the pyramid with the
parallel-axis shift through the mixed-radix top level; capped by the
bounding radius) for k = 3, 2.5, 2, beside the geometric MAC ("geom"), and
gives for each the force error against the direct sum at N = --n-rms and
the time of one force evaluation at N = --n.

Each evaluation is the script's: `bh._prepare` (Hilbert curve,
quadrupoles) at --leaf, optionally the rms radii, `bh.traverse` and
`bh._forces_sorted` at --near / --far with far_mode="gather" (the JAX
package's default there; the port's is "octet"), so K1 and K4 run, as in
the script, compute_pot=False, softening 0.01; the forces back in input
order. The reference at --n-rms is K3's f32 direct sum
(`direct_kernels.allpairs_accel_tile`, in place of the script's
`pallas_accel_tile`). The flag defaults are the script's LEAF, NB, FB and
THETA, chosen for the TPU: every row prints its overflow at both sizes, as
theta_sweep does.

The script timed 1M on the host clock over 5 calls; here each mode's 1M
evaluation has events ms and busy ms (`measure.phase`, the mean of
--iters calls after a warm-up) and, beside them, the host-clock ms of the
same --iters calls. On the card the first --n-rms evaluation of each mode
is also held against the plain versions of K1 and K4 on SAMPLE_ROWS target
leaves of the same lists (rtol 2e-4 / atol 2e-5). `--device cpu` (the
tests) runs the plain versions and times nothing. Every line is one JSON
object carrying the card's name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse
import time

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh, bh_kernels, direct_kernels
from parallelnbody_tpu_torch.tools import measure, near_rates
from parallelnbody_tpu_torch.tools.near_rates import ATOL, RTOL

LEAF, NB, FB, THETA = 256, 3584, 1536, 0.72   # the script's constants
SOFTENING = 0.01
MODES = (("geom", 0.0), ("rms", 3.0), ("rms", 2.5), ("rms", 2.0))
SAMPLE_ROWS = 16


def rms_radii(pos_s, mass_s, tree, leaf):
    """Mass-weighted rms member distance per node, per level (the
    parallel-axis shift upward; b from the widths, so the mixed-radix top
    level too)."""
    n_leaves = tree.com[0].shape[0]
    p = pos_s.reshape(n_leaves, leaf, 3)
    m = mass_s.reshape(n_leaves, leaf)
    msum = torch.clamp(torch.sum(m, dim=1), min=1e-30)
    d2 = torch.sum((p - tree.com[0][:, None, :]) ** 2, dim=-1)
    s2 = [torch.sum(m * d2, dim=1) / msum]
    for k in range(1, tree.n_levels):
        b = tree.com[k - 1].shape[0] // tree.com[k].shape[0]
        mm = tree.mass[k - 1].reshape(-1, b)
        cc = tree.com[k - 1].reshape(-1, b, 3)
        shift = torch.sum((cc - tree.com[k][:, None, :]) ** 2, dim=-1)
        mk = torch.clamp(tree.mass[k], min=1e-30)
        s2.append(torch.sum(mm * (s2[-1].reshape(-1, b) + shift), dim=1)
                  / mk)
    return [torch.sqrt(x) for x in s2]


def _tree(pos, mass, mode, k_rms, leaf):
    pos_s, mass_s, perm, tree, n, n_pad = bh._prepare(
        pos, mass, leaf_size=leaf, curve="hilbert", multipole_order=2)
    if mode == "rms":
        rr = rms_radii(pos_s, mass_s, tree, leaf)
        # capped by the bounding radius: k * rms exceeds it only for tiny
        # nodes, and the MAC is never looser than the geometric one needs
        tree = tree._replace(radius=tuple(
            torch.minimum(k_rms * r, t) for r, t in zip(rr, tree.radius)))
    return pos_s, mass_s, perm, tree, n, n_pad


def forces(pos, mass, mode, k_rms, *, leaf, near, far, theta):
    """One evaluation: (acc (n, 3) in input order, overflow)."""
    pos_s, mass_s, perm, tree, n, n_pad = _tree(pos, mass, mode, k_rms, leaf)
    far_masks, rejects = bh.traverse(tree, theta)
    setup = bh.BHSetup.make(n, leaf_size=leaf, theta=theta,
                            softening=SOFTENING, near_budget=near,
                            far0_budget=far, multipole=2, compute_pot=False,
                            far_mode="gather")
    acc, pot, ovf = bh._forces_sorted(
        pos_s, mass_s, tree, far_masks, rejects, setup, start_leaf=0,
        n_slice=n_pad // leaf)
    return bh._unsort(acc, pot, perm, n)[0], ovf


def held_to_plain(pos, mass, mode, k_rms, acc, *, leaf, near, far, theta):
    """max |acc - plain| on SAMPLE_ROWS target leaves: the same lists
    evaluated by the plain versions of K1 and K4 (in the sum order of
    `bh._forces_sorted`: the upper far list, the leaf far list, the near
    field); raises beyond rtol / atol."""
    pos_s, mass_s, perm, tree, n, n_pad = _tree(pos, mass, mode, k_rms, leaf)
    n_leaves = n_pad // leaf
    far_masks, rejects = bh.traverse(tree, theta)
    (ni, nv, f0i, f0v, upi, upv, nodes_up, leaf_nodes,
     _) = bh.build_interaction_lists(
        tree, far_masks, rejects, theta=theta, start_leaf=0,
        n_slice=n_leaves, near_budget=near, far0_budget=far,
        dtype=pos_s.dtype)
    rows = near_rates.sample_rows(n_leaves, pos.device, SAMPLE_ROWS)
    tgt = pos_s.reshape(n_leaves, leaf, 3)[rows]
    kw = dict(g=1.0, softening=SOFTENING, compute_pot=False)
    a_up, _ = bh_kernels.far_gather_plain(tgt, nodes_up, upi[rows],
                                          upv[rows], **kw)
    a_l, _ = bh_kernels.far_gather_plain(tgt, leaf_nodes, f0i[rows],
                                         f0v[rows], **kw)
    a_n, _ = bh_kernels.near_field_plain(pos_s, mass_s, tgt, ni[rows],
                                         nv[rows], **kw)
    want = a_up + a_l + a_n
    slots = (rows[:, None] * leaf + torch.arange(leaf, device=pos.device)
             ).flatten()
    live = perm[slots] < n
    got = acc[perm[slots][live]]
    return measure.max_abs_err(f"mac_experiment {mode} k={k_rms} K1 + K4",
                               got, want[live], RTOL, ATOL)


def errors(acc, ref):
    """rms, p99.9 and max of the per-particle relative force error."""
    e = (torch.linalg.norm((acc - ref).double(), dim=1)
         / torch.linalg.norm(ref.double(), dim=1))
    return {"rms": float(torch.sqrt(torch.mean(e * e))),
            "p999": float(torch.quantile(e, 0.999)),
            "max": float(e.max())}


def run(pos, mass, mode, k_rms, *, leaf=LEAF, near=NB, far=FB, theta=THETA,
        ref=None, time_it=False, iters=5):
    """The script's `run` on pos / mass: {"ovf"} and, against ref, the
    errors; with time_it the events / busy / host-clock ms of one
    evaluation. On the card, with ref, the evaluation is also held to the
    plain versions (`held_to_plain`)."""
    kw = dict(leaf=leaf, near=near, far=far, theta=theta)
    dev = pos.device
    if time_it:
        (acc, ovf), times = measure.phase(
            lambda: forces(pos, mass, mode, k_rms, **kw), iters, dev)
    else:
        acc, ovf = forces(pos, mass, mode, k_rms, **kw)
        times = {}
    out = {"ovf": int(ovf)}
    if ref is not None:
        out |= errors(acc, ref)
        if dev.type == "cuda":
            out["max_abs_err_plain"] = held_to_plain(pos, mass, mode, k_rms,
                                                     acc, **kw)
    if time_it and dev.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            forces(pos, mass, mode, k_rms, **kw)
        torch.cuda.synchronize()
        out |= {**times, "host_ms": (time.perf_counter() - t0) / iters * 1e3}
    elif time_it:
        out |= times
    return out


def _state(n, dev):
    return init_simulation(SimConfig(n=n, ic="plummer", softening=0.01,
                                     track_potential=False), dev,
                           compute_forces=False)


def experiment(small, big, args, out=None):
    """Every mode on the states small (errors) and big (time); emits and
    returns the records."""
    dev = small.pos.device
    ref, _ = direct_kernels.allpairs_accel_tile(
        small.pos, small.pos, small.mass, g=1.0, softening=SOFTENING,
        compute_pot=False)
    kw = dict(leaf=args.leaf, near=args.near, far=args.far,
              theta=args.theta)
    base = {"tool": "mac_experiment", "card": measure.card_of(dev),
            "n_rms": small.pos.shape[0], "n": big.pos.shape[0], **kw}
    records = []
    for mode, k in MODES:
        r = run(small.pos, small.mass, mode, k, ref=ref, **kw)
        t = run(big.pos, big.mass, mode, k, time_it=True, iters=args.iters,
                **kw)
        rec = {**base, "mode": mode, "k": k, "rms": r["rms"],
               "p999": r["p999"], "max": r["max"], "overflow_rms": r["ovf"],
               "max_abs_err_plain": r.get("max_abs_err_plain"),
               "overflow": t["ovf"],
               **{key: t.get(key) for key in ("ms", "busy_ms", "busy_share",
                                              "host_ms")}}
        records.append(rec)
        measure.emit(rec, out)
    return records


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leaf", type=int, default=LEAF)
    ap.add_argument("--near", type=int, default=NB)
    ap.add_argument("--far", type=int, default=FB)
    ap.add_argument("--theta", type=float, default=THETA)
    ap.add_argument("--n-rms", type=int, default=262144)
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    return experiment(_state(args.n_rms, dev), _state(args.n, dev), args,
                      out=args.out)


if __name__ == "__main__":
    main()
