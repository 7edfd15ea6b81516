"""tools/sections_probe.py on the CPU against the JAX package's bh_accel.

At N = 65536 (the JAX package's seed-0 Plummer particles), leaf 64 (1024
leaves, staged) and budgets small enough for the plain versions on the CPU
(near 32, far 128, the script's candidate budgets 256 / 512; they clip),
the forces in 1 and 4 windows are bit-equal, and each row's overflow
equals the JAX package's `bh_accel` at the same budgets. Out of memory is
a row, any other error propagates.
"""

import jax
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.tools import sections_probe as tool

torch.set_num_threads(2)

N, LEAF, NEAR, FAR = 65536, 64, 32, 128
CPU = torch.device("cpu")


def test_windows_bit_equal_and_overflow_equal_jax():
    cfg = JaxConfig(n=N, ic="plummer", softening=0.01, dt=1e-4,
                    force="barnes_hut")
    pos, _, mass = get_ic("plummer")(jax.random.key(cfg.seed), cfg)
    rows = tool.probe(torch.from_numpy(np.array(pos)),
                      torch.from_numpy(np.array(mass)), [1, 4], leaf=LEAF,
                      theta=0.72, near=NEAR, far=FAR, iters=1, dev=CPU)
    assert [(r["sections"], r["resolved"], r["bit_equal_to"], r["oom"])
            for r in rows] == [(1, 1, 1, False), (4, 4, 1, False)]
    for r in rows:
        _, _, of = jbh.bh_accel(
            pos, mass, leaf_size=LEAF, theta=0.72, g=1.0, softening=0.01,
            near_budget=NEAR, far0_budget=FAR, multipole=2,
            compute_pot=False, refine="staged",
            cand_budgets=tool.CAND_BUDGETS, sections=r["sections"])
        assert r["overflow"] == int(of) > 0


def _tiny():
    cfg = JaxConfig(n=4096, ic="plummer")
    pos, _, mass = get_ic("plummer")(jax.random.key(1), cfg)
    return torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(mass))


def test_out_of_memory_is_a_row_and_other_errors_raise(monkeypatch):
    real = tbh.bh_accel

    def accel(*a, sections, **k):
        if sections == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried")
        return real(*a, sections=sections, **k)

    monkeypatch.setattr(tbh, "bh_accel", accel)
    pos, mass = _tiny()
    kw = dict(leaf=32, theta=0.72, near=64, far=256, iters=1, dev=CPU)
    rows = tool.probe(pos, mass, [1, 2], **kw)
    assert [r["oom"] for r in rows] == [False, True]
    assert rows[1]["error"].startswith("CUDA out of memory")

    def broken(*a, **k):
        raise RuntimeError("not a memory fault")

    monkeypatch.setattr(tbh, "bh_accel", broken)
    with pytest.raises(RuntimeError, match="not a memory fault"):
        tool.probe(pos, mass, [1], **kw)


def test_differing_windows_raise(monkeypatch):
    real = tbh.bh_accel

    def accel(*a, sections, **k):
        acc, pot, of = real(*a, sections=sections, **k)
        return (acc + 1e-7 if sections > 1 else acc), pot, of

    monkeypatch.setattr(tbh, "bh_accel", accel)
    pos, mass = _tiny()
    with pytest.raises(AssertionError, match="forces differ"):
        tool.probe(pos, mass, [1, 2], leaf=32, theta=0.72, near=64, far=256,
                   iters=1, dev=CPU)
