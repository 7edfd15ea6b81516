"""Barnes-Hut theta against force error and time on one CUDA device: the
port of scripts/theta_sweep.py.

    python3 -m parallelnbody_tpu_torch.tools.theta_sweep [--near 512]
        [--far 2048] [--n-rms 262144] [--n 1048576]
        [--iters 5] [--device cuda] [--out FILE]

For theta = 0.7, 0.75, 0.8 and 0.85, at the script's leaf (LEAF, 256),
Hilbert curve, quadrupoles and budgets (--near / --far), `bh.bh_accel`
with its defaults otherwise (dense, octet far field, the potential
computed):

  * the rms relative force error at N = --n-rms against the f32 direct
    sum of K3 (`direct_kernels.allpairs_accel_tile`, in place of the
    script's `pallas_accel_tile`), and the overflow there;
  * at N = --n, ms of one evaluation (events ms, the mean of --iters calls
    after a warm-up by CUDA events, and busy ms from torch.profiler,
    `measure.phase`) and its overflow.

Both inputs are the script's: `init_simulation(SimConfig(n, ic="plummer",
softening=0.01))`. The budgets are the TPU's choices; at N = 1M they clip,
and every row prints its overflow, as the script did. `--device cpu` (the
tests) runs the plain versions and times nothing. Every line is one JSON
object carrying the card's name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import direct_kernels
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.tools.bh_breakdown import Spec

THETAS = (0.7, 0.75, 0.8, 0.85)
LEAF = 256


def _state(n, dev):
    return init_simulation(SimConfig(n=n, ic="plummer", softening=0.01),
                           dev, compute_forces=False)


def sweep(dev, n_rms, n, near, far, leaf=LEAF, iters=5, out=None):
    """The script's four rows on dev; emits and returns them."""
    small = _state(n_rms, dev)
    acc_ref = direct_kernels.allpairs_accel_tile(
        small.pos, small.pos, small.mass, g=1.0, softening=0.01)[0]
    ref_norm = torch.sqrt(torch.mean(torch.sum(acc_ref * acc_ref, dim=1)))
    big = _state(n, dev)
    base = {"tool": "theta_sweep", "card": measure.card_of(dev),
            "n_rms": n_rms, "n": n, "leaf": leaf, "near": near, "far": far}
    records = []
    for theta in THETAS:
        spec = Spec(leaf=leaf, theta=theta, near=near, far=far).resolved(n)
        acc, _, of_small = spec.accel(small.pos, small.mass)
        err = torch.sqrt(torch.mean(torch.sum((acc - acc_ref) ** 2, dim=1)))
        got, times = measure.phase(lambda: spec.accel(big.pos, big.mass),
                                   iters, dev)
        rec = {**base, "theta": theta, "rms_err": float(err / ref_norm),
               "overflow_rms": int(of_small), "overflow": int(got[2]),
               **times}
        del acc, got
        measure.emit(rec, out)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--near", type=int, default=512)
    ap.add_argument("--far", type=int, default=2048)
    ap.add_argument("--n-rms", type=int, default=262144)
    ap.add_argument("--n", type=int, default=1048576)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    return sweep(dev, args.n_rms, args.n, args.near, args.far,
                 iters=args.iters, out=args.out)


if __name__ == "__main__":
    main()
