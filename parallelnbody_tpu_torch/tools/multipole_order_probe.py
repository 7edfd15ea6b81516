"""How far theta opens per multipole order (monopole, quadrupole,
octupole) on one CUDA device: the port of scripts/multipole_order_probe.py.

    python3 -m parallelnbody_tpu_torch.tools.multipole_order_probe
        [--seed 0] [--iters 5] [--device cuda] [--out FILE]

For random Plummer-profile clumps of 256 particles (masses uniform in
[0.5, 1.5], radii capped at 5 scale lengths), the exact acceleration at
test points alpha * r_clump from the clump's CoM (r_clump its largest
member distance, 8 random directions an alpha, 40 clumps) against the
monopole, quadrupole and octupole expansions about the CoM (G = 1), in
f64. Printed: the rms relative error per alpha and order, and for the
targets rms < 1e-3 and < 3e-4 the first alpha below each, as theta <=
1 / alpha (the group MAC's theta) per order.

The script drew from a module-level `numpy.random.default_rng(0)`; here
the generator is an argument (`--seed`, `numpy.random.Generator`), drawn
in the script's order (each clump's masses, radii and directions, then
its test directions alpha by alpha), so one seed gives the script's
clumps and points. The moments and the sums run in f64 torch on the
device, batched over clumps, alphas and directions; their events ms and
busy ms (`measure.phase`) are on the last line. `--device cpu` (the
tests) times nothing. Every line is one JSON object carrying the card's
name and power limit (appended to --out).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from parallelnbody_tpu_torch.tools import measure

ALPHAS = (1.0, 1.1, 1.25, 1.4, 1.6, 1.8, 2.0, 2.3, 2.6, 3.0)
N_CLUMPS, N_DIRS, CLUMP_N = 40, 8, 256
ORDERS = (1, 2, 3)
TARGETS = (1e-3, 3e-4)


def draw(rng, n_clumps=N_CLUMPS, n_dirs=N_DIRS, n=CLUMP_N, a=1.0,
         alphas=ALPHAS):
    """The script's draws in its order: (p (C, n, 3), m (C, n), u (C, A,
    D, 3)) as numpy f64, positions about the origin and unit test
    directions."""
    ps, ms, us = [], [], []
    for _ in range(n_clumps):
        m = rng.uniform(0.5, 1.5, n)
        x = rng.uniform(0, 1, n)
        r = np.minimum(a / np.sqrt(x ** (-2.0 / 3.0) - 1.0), 5 * a)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        ps.append(r[:, None] * u)
        ms.append(m)
        dirs = []
        for _ in alphas:
            for _ in range(n_dirs):
                v = rng.normal(size=3)
                dirs.append(v / np.linalg.norm(v))
        us.append(np.reshape(dirs, (len(alphas), n_dirs, 3)))
    return np.stack(ps), np.stack(ms), np.stack(us)


def moments(p, m):
    """Batched over clumps: (M (C,), com (C, 3), r (C,), Q (C, 3, 3),
    O (C, 3, 3, 3)), traceless about the CoM."""
    M = m.sum(1)
    com = (m[:, :, None] * p).sum(1) / M[:, None]
    d = p - com[:, None, :]
    r = torch.sqrt((d * d).sum(-1)).amax(1)
    d2 = (d * d).sum(-1)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    Q = (3 * torch.einsum("cn,cni,cnj->cij", m, d, d)
         - eye * (m * d2).sum(1)[:, None, None])
    t = 15 * torch.einsum("cn,cni,cnj,cnk->cijk", m, d, d, d)
    md = torch.einsum("cn,cnk->ck", m * d2, d)
    t = t - 3 * (eye[None, :, :, None] * md[:, None, None, :]
                 + eye[None, :, None, :] * md[:, None, :, None]
                 + eye[None, None, :, :] * md[:, :, None, None])
    return M, com, r, Q, t


def approx_acc(x, com, M, Q, O, order):
    """Acceleration at the points x (C, P, 3) from each clump's multipoles
    about com (G = 1), to the given order."""
    dvec = com[:, None, :] - x
    d2 = (dvec * dvec).sum(-1)
    u = 1.0 / torch.sqrt(d2)
    a = (M[:, None] * u ** 3)[..., None] * dvec
    if order >= 2:
        qd = torch.einsum("cij,cpj->cpi", Q, dvec)
        qq = (dvec * qd).sum(-1)
        a = a + (2.5 * qq * u ** 7)[..., None] * dvec - u[..., None] ** 5 * qd
    if order >= 3:
        od = torch.einsum("cijk,cpj,cpk->cpi", O, dvec, dvec)
        ooo = torch.einsum("cijk,cpi,cpj,cpk->cp", O, dvec, dvec, dvec)
        a = (a + 0.5 * u[..., None] ** 7 * od
             - ((7.0 / 6.0) * ooo * u ** 9)[..., None] * dvec)
    return a


def exact_acc(x, p, m):
    """The direct sum at x (C, P, 3) over each clump's particles."""
    d = p[:, None, :, :] - x[:, :, None, :]
    r2 = (d * d).sum(-1)
    w = m[:, None, :] * r2 ** -1.5
    return (w[..., None] * d).sum(2)


def order_table(p, m, u, alphas=ALPHAS):
    """rms relative error (A, 3): per alpha (over clumps and directions),
    per order."""
    M, com, r, Q, O = moments(p, m)
    al = torch.tensor(alphas, dtype=p.dtype, device=p.device)
    c, a, d, _ = u.shape
    x = (com[:, None, None, :] + (al[None, :, None, None] * r[:, None, None,
                                                              None]) * u)
    x = x.reshape(c, a * d, 3)
    ex = exact_acc(x, p, m)
    nrm = torch.linalg.norm(ex, dim=-1)
    rows = []
    for order in ORDERS:
        e = torch.linalg.norm(approx_acc(x, com, M, Q, O, order) - ex,
                              dim=-1) / nrm
        rows.append(torch.sqrt((e.reshape(c, a, d) ** 2).mean(dim=(0, 2))))
    return torch.stack(rows, dim=1)


def thresholds(table, alphas=ALPHAS):
    """{target: {order: theta (1 / the first alpha below target) or
    None}}, the script's search."""
    out = {}
    for target in TARGETS:
        out[target] = {}
        for j, order in enumerate(ORDERS):
            best = next((al for al, row in zip(alphas, table)
                         if row[j] < target), None)
            out[target][order] = None if best is None else 1 / best
    return out


def probe(rng, dev, iters=5, out=None):
    """The script's table from rng's draws, on dev; emits and returns the
    records (one an alpha, one a target, then the timing)."""
    p, m, u = (torch.from_numpy(a).to(dev) for a in draw(rng))
    table, times = measure.phase(lambda: order_table(p, m, u), iters, dev)
    table = table.cpu().numpy()
    base = {"tool": "multipole_order_probe", "card": measure.card_of(dev)}
    records = []
    for al, row in zip(ALPHAS, table):
        records.append({**base, "alpha": al, "mono_rms": float(row[0]),
                        "quad_rms": float(row[1]), "oct_rms": float(row[2])})
    for target, theta in thresholds(table).items():
        records.append({**base, "target": target,
                        **{f"order{o}_theta": t for o, t in theta.items()}})
    records.append({**base, "clumps": N_CLUMPS, "dirs": N_DIRS,
                    "clump_n": CLUMP_N, **times})
    for rec in records:
        measure.emit(rec, out)
    return records


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = measure.device_of(args.device)
    return probe(np.random.default_rng(args.seed), dev, args.iters,
                 out=args.out)


if __name__ == "__main__":
    main()
