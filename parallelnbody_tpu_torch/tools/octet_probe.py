"""Gather against octet far field, whole Barnes-Hut evaluations on one CUDA
device: the port of scripts/octet_probe.py and scripts/octet_probe2.py in
one tool.

    python3 -m parallelnbody_tpu_torch.tools.octet_probe [--set probe]
        [--n N] [--theta 0.72] [--quick] [--device cuda] [--out FILE]

--set probe is octet_probe.py: at N = --n (1048576) and --theta, leaf 256
dense with near 3584 / far 2816, gather then octet, then leaf 128 staged
with near 2048 / far 4096, gather then octet (--quick: the first two).
The other sets are octet_probe2.py's, theta 0.72, each case with the
budgets and candidate budgets it names there (near 3584 / far 2816 and
automatic candidate budgets where it names none): 1m (N = 2^20: leaf 128
dense and staged, leaf 256 staged, octet), 4m and 8m (N = 2^22, 2^23:
leaf 256 staged, gather then octet), galaxy (the galaxy_collision ICs at
N = 2^21, leaf 128 staged, gather then octet), leaf4m, leaf8m and leafgal
(leaf 128 against leaf 256, staged octet). --n replaces a set's N (the
tests' small sizes).

Inputs are the scripts': `init_simulation(SimConfig(n, ic, softening=0.01,
dt=1e-4, force="barnes_hut"))` without the t = 0 forces. Each case times
the whole `bh.bh_accel` (compute_pot=False, Hilbert curve, quadrupoles):
events ms (the mean of the script's 5 or 3 calls after a warm-up, by CUDA
events) and busy ms (`measure.phase`), with its overflow. The budgets are
the TPU's choices at leaf 256 and may clip on these inputs: the overflow
is printed for every case. One more evaluation, the phases of
tools/bh_breakdown.py run untimed, counts the far kernel's accepted terms
(K2: the accepted children of the octet entries times G targets; K4: the
listed node rows times G) and the near pairs, so that cases of another N
compare per term. `--device cpu` (the tests) runs the plain versions and
times nothing. Every line is one JSON object carrying the card's name and
power limit (appended to --out).
"""

from __future__ import annotations

import argparse

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.tools.bh_breakdown import Spec, phases

M1, M2, M4, M8 = 1 << 20, 1 << 21, 1 << 22, 1 << 23
# (n, ic, leaf, refine, far_mode, near, far, cands, iters); n None = --n.
_P = "plummer"
SETS = {
    "probe": [(None, _P, 256, "dense", "gather", 3584, 2816, (0, 0), 5),
              (None, _P, 256, "dense", "octet", 3584, 2816, (0, 0), 5),
              (None, _P, 128, "staged", "gather", 2048, 4096, (0, 0), 5),
              (None, _P, 128, "staged", "octet", 2048, 4096, (0, 0), 5)],
    "1m": [(M1, _P, 128, "dense", "octet", 2048, 2048, (0, 0), 5),
           (M1, _P, 128, "staged", "octet", 2048, 2048, (128, 512), 5),
           (M1, _P, 256, "staged", "octet", 3584, 2048, (0, 0), 5)],
    "4m": [(M4, _P, 256, "staged", "gather", 3584, 2816, (0, 0), 3),
           (M4, _P, 256, "staged", "octet", 3584, 2816, (0, 0), 3)],
    "8m": [(M8, _P, 256, "staged", "gather", 3584, 2816, (0, 0), 3),
           (M8, _P, 256, "staged", "octet", 3584, 2816, (0, 0), 3)],
    "galaxy": [(M2, "galaxy_collision", 128, "staged", "gather", 1024, 2048,
                (0, 0), 3),
               (M2, "galaxy_collision", 128, "staged", "octet", 1024, 2048,
                (0, 0), 3)],
    "leaf4m": [(M4, _P, 128, "staged", "octet", 2048, 2560, (0, 0), 3),
               (M4, _P, 256, "staged", "octet", 3584, 2816, (0, 0), 3)],
    "leaf8m": [(M8, _P, 128, "staged", "octet", 2048, 2560, (0, 0), 3),
               (M8, _P, 256, "staged", "octet", 3584, 2816, (0, 0), 3)],
    "leafgal": [(M2, "galaxy_collision", 128, "staged", "octet", 3072, 2560,
                 (0, 0), 3),
                (M2, "galaxy_collision", 256, "staged", "octet", 3584, 2816,
                 (0, 0), 3)],
}
FAR_PHASES = ("K2 far_octet", "K4 far_gather", "K4 far_gather upper",
              "K4 far_gather leaf")


def counts(pos, mass, spec):
    """{"far_terms", "far_bound_ms", "near_pairs", "near_bound_ms"} of
    one evaluation at spec, from the phases' own statistics."""
    infos = {}

    def run(name, fn, info=None):
        got = fn()
        if info is not None:
            infos[name] = info(got)
        return got

    phases(pos, mass, spec, run)
    far = [infos[k] for k in FAR_PHASES if k in infos]
    return {"far_terms": sum(f["pairs"] for f in far),
            "far_bound_ms": sum(f["bound_ms"] for f in far),
            "near_pairs": infos["K1 near_field"]["pairs"],
            "near_bound_ms": infos["K1 near_field"]["bound_ms"]}


def cases(name, n=None, theta=0.72, quick=False):
    """The set's cases as (n, ic, Spec, iters); theta is the probe set's
    (octet_probe2.py's sets run at 0.72)."""
    rows = SETS[name][:2] if quick else SETS[name]
    theta = theta if name == "probe" else 0.72
    return [(n or row_n or M1, ic,
             Spec(leaf=leaf, theta=theta, near=near, far=far, refine=refine,
                  far_mode=far_mode, cands=cands, compute_pot=False), iters)
            for row_n, ic, leaf, refine, far_mode, near, far, cands, iters
            in rows]


def probe(name, dev, n=None, theta=0.72, quick=False, out=None):
    """Runs the set's cases on dev; emits and returns one record a case."""
    base = {"tool": "octet_probe", "card": measure.card_of(dev),
            "set": name}
    states, records = {}, []
    for n_case, ic, spec, iters in cases(name, n, theta, quick):
        if (n_case, ic) not in states:
            states.clear()
            cfg = SimConfig(n=n_case, ic=ic, softening=0.01, dt=1e-4,
                            force="barnes_hut")
            states[(n_case, ic)] = init_simulation(cfg, dev,
                                                   compute_forces=False)
        state = states[(n_case, ic)]
        spec = spec.resolved(n_case)
        got, times = measure.phase(
            lambda: spec.accel(state.pos, state.mass), iters, dev)
        rec = {**base, "n": n_case, "ic": ic, "leaf": spec.leaf,
               "refine": spec.refine, "far_mode": spec.far_mode,
               "near": spec.near, "far_b": spec.far,
               "cands": list(spec.cands), "theta": spec.theta,
               "iters": iters, **times, "overflow": int(got[2]),
               "far_kernel": "K2" if spec.far_mode == "octet" else "K4"}
        del got
        rec.update(counts(state.pos, state.mass, spec))
        measure.emit(rec, out)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", default="probe", choices=tuple(SETS))
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--theta", type=float, default=0.72)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = measure.device_of(args.device)
    return probe(args.set, dev, args.n, args.theta, args.quick, args.out)


if __name__ == "__main__":
    main()
