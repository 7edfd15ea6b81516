"""The pyramid refresh of a frozen-list evaluation (ops/bh.py
`_refresh_nodes8`), on the CPU.

On the card the refresh is one pass of csrc/pyramid.cu
(`bh_kernels.pyramid_rows`), which writes K2's node table packed as
`bh_kernels.far_rows` packs it; on the CPU it is `bh.refresh_plain`, the
pyramid `build_tree` builds, stacked by `_nodes_all_octet` and packed by
`far_rows`. Here: the level
plan the wrapper passes to the kernel (`bh._pyramid_plan`) places every
level where `_nodes_all_octet` places it, for a radix-8 chain, a mixed-radix
top and a capped level count; the CPU refresh is the pyramid of the live
rows' domain cube, packed, bit for bit, with pads and empty leaves; K2's plain
version gives the same bits from the packed table as from the (n8, 9) one;
and a rebuild-interval run on the CPU refreshes every step and launches
nothing. The kernel itself is held to the plain version in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from parallelnbody_tpu_torch import SimConfig, Simulation
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.ops import bh, bh_kernels

torch.set_num_threads(2)


def _rows(n, seed, leaf):
    """n random bodies (Gaussian positions, masses in [0.5, 1.5)) padded
    to the plan's rows with zero-mass pads at the origin, as the
    rebuild-interval runs carry them, in Hilbert order."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    _, n_pad, _ = bh.plan_tree(n, leaf)
    perm, _ = bh._curve_order(pos, "hilbert")
    pos_s = torch.cat([pos[perm], pos.new_zeros((n_pad - n, 3))])
    mass_s = torch.cat([mass[perm], mass.new_zeros(n_pad - n)])
    return pos_s, mass_s


@pytest.mark.parametrize("n_leaves, max_levels, widths", [
    (512, 12, [512, 64, 8, 1]),
    (1024, 12, [1024, 128, 16, 2, 1]),
    (2048, 12, [2048, 256, 32, 4, 1]),
    (4096, 3, [4096, 512, 64]),
], ids=["radix8", "top2", "top4", "capped"])
def test_plan_places_levels_as_nodes_all_octet(n_leaves, max_levels, widths):
    """The plan's widths are build_tree's levels and its rows are where
    _nodes_all_octet stacks them; the rows between are zero pads."""
    leaf = 2
    rng = np.random.default_rng(n_leaves + max_levels)
    pos = torch.from_numpy(
        rng.standard_normal((n_leaves * leaf, 3)).astype(np.float32))
    mass = torch.ones(n_leaves * leaf)
    _, _, sentinel = bh.domain_cube(pos.amin(0), pos.amax(0))
    tree = bh.build_tree(pos, mass, leaf, sentinel, multipole_order=2,
                         max_levels=max_levels)
    got_widths, rows, n8 = bh._pyramid_plan(n_leaves, max_levels)
    assert list(got_widths) == widths == [c.shape[0] for c in tree.com]
    assert bh._count_levels(n_leaves, max_levels) == len(widths)
    table = bh._nodes_all_octet(tree, torch.float32)
    assert table.shape[0] == n8
    assert rows[0] == 0 and all(r % 8 == 0 for r in rows)
    ends = [*rows[1:], n8]
    for k, (w, r, end) in enumerate(zip(widths, rows, ends)):
        assert torch.equal(table[r:r + w], bh._node_table(tree, k,
                                                          torch.float32))
        assert end - r == -(-w // 8) * 8
        assert not bool(table[r + w:end].any())


@pytest.mark.parametrize("multipole", [1, 2])
@pytest.mark.parametrize("n, leaf, max_levels", [
    (3000, 16, 12), (3000, 16, 3), (5000, 32, 12)],
    ids=["leaf16", "leaf16_capped", "leaf32"])
def test_cpu_refresh_is_the_live_rows_pyramid(n, leaf, max_levels,
                                              multipole):
    """_refresh_nodes8 on CPU tensors equals, bit for bit, the pyramid of
    the sorted rows in the domain cube of the live rows, stacked 8-aligned
    and packed for K2 (build_tree + _nodes_all_octet + far_rows, the
    refresh before the pass); the trailing leaves, pads only, are
    empty: centre the sentinel, mass and quadrupole 0. Nothing launches."""
    pos_s, mass_s = _rows(n, 11, leaf)
    n_leaves = pos_s.shape[0] // leaf
    _, _, sentinel = bh.domain_cube(pos_s[:n].amin(0), pos_s[:n].amax(0))
    tree = bh.build_tree(pos_s, mass_s, leaf, sentinel,
                         multipole_order=multipole, max_levels=max_levels)
    want = bh_kernels.far_rows(bh._nodes_all_octet(tree, torch.float32))
    before = bh_kernels.REFRESH_LAUNCHES["refresh"]
    got = bh._refresh_nodes8(pos_s, mass_s, leaf_size=leaf,
                             multipole=multipole, max_levels=max_levels,
                             n_live=n)
    assert bh_kernels.REFRESH_LAUNCHES["refresh"] == before
    assert got.shape == want.shape == (bh._pyramid_plan(
        n_leaves, max_levels)[2], 12 if multipole == 2 else 4)
    assert torch.equal(got, want)
    empty = -(-(pos_s.shape[0] - n) // leaf) - 1  # leaves of pads alone
    assert empty > 0
    tail = got[n_leaves - empty:n_leaves]
    assert torch.equal(tail[:, :3], sentinel.expand(empty, 3))
    assert not bool(tail[:, 3:].any())


def test_far_octet_plain_reads_the_packed_table():
    """K2's plain version gives the same bits from the table packed as
    far_rows packs it (n8, 12), as the refresh on the card writes it, as
    from the (n8, 9) table; the packed table passes far_rows as it is."""
    leaf = 16
    state = init_simulation(SimConfig(n=2048, ic="plummer", seed=5), "cpu",
                            compute_forces=False)
    pos_s, _, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // leaf
    far, rej = bh.traverse(tree, 0.72)
    _, _, keys, valid, nodes8, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=0.72, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0 and bool(valid.any())
    packed = bh_kernels.far_rows(nodes8)
    assert packed.shape == (nodes8.shape[0], 12)
    assert bh_kernels.far_rows(packed) is packed
    tgt = pos_s.reshape(n_leaves, leaf, 3)
    kw = dict(g=1.0, softening=0.01, compute_pot=True)
    a9, p9 = bh_kernels.far_octet(tgt, nodes8, keys, valid, **kw)
    a12, p12 = bh_kernels.far_octet(tgt, packed, keys, valid, **kw)
    assert torch.equal(a9, a12) and torch.equal(p9, p12)
    assert bool(a9.abs().sum() > 0)


def test_rebuild_interval_run_refreshes_each_step_on_the_cpu(monkeypatch):
    """A step(8) call at rebuild 8 on the CPU refreshes the pyramid once a
    step, 8 times, through the plain version: the refresh's launch count
    stays 0, and the kernel's wrapper refuses CPU tensors."""
    calls = []
    refresh = bh._refresh_nodes8

    def counted(*args, **kwargs):
        calls.append(kwargs["n_live"])
        return refresh(*args, **kwargs)

    monkeypatch.setattr(bh, "_refresh_nodes8", counted)
    cfg = SimConfig(n=2048, ic="plummer", force="barnes_hut", theta=0.72,
                    bh_leaf_size=16, bh_multipole=2, bh_rebuild_every=8,
                    dt=1e-3, track_potential=False)
    sim = Simulation(cfg, device="cpu")
    before = bh_kernels.REFRESH_LAUNCHES["refresh"]
    sim.step(8)
    assert calls == [2048] * 8
    assert bh_kernels.REFRESH_LAUNCHES["refresh"] == before
    assert int(sim.state.step) == 8 and int(sim.overflow) == 0
    assert bool(torch.isfinite(sim.state.acc).all())
    pos_s, mass_s = _rows(100, 3, 16)
    with pytest.raises(ValueError, match="card"):
        bh_kernels.pyramid_rows(pos_s, mass_s, bh._pyramid_plan(8, 12),
                                leaf_size=16, quad=True, n_live=100)


def test_pyramid_close_holds_what_the_card_tests_hold():
    """tools/measure.pyramid_close, the card tests' hold on the pass, on
    the CPU: the plain table against itself reads 0; a quadrupole moved by
    twice its tolerance of the node's sum m |d|^2, a centre moved by
    twice its tolerance, or an empty row changed at all, raise."""
    from parallelnbody_tpu_torch.tools import measure

    leaf, n = 16, 3000
    pos_s, mass_s = _rows(n, 7, leaf)
    kw = dict(leaf_size=leaf, max_levels=12, n_live=n)
    want = bh.refresh_plain(pos_s, mass_s, multipole=2, **kw)
    assert measure.pyramid_close("same", want.clone(), want, pos_s, mass_s,
                                 **kw) == {"mass": 0.0, "com": 0.0,
                                           "quad": 0.0}
    row = int(torch.nonzero(want[:, 3] > 0)[0])
    d = pos_s[row * leaf:(row + 1) * leaf].double() - want[row, :3].double()
    scale = float((mass_s[row * leaf:(row + 1) * leaf].double() *
                   (d * d).sum(1)).sum())
    _, half, _ = bh._cube_of(pos_s[:n])
    com_tol = (measure.PYRAMID_RTOL * float(want[row, 0].abs()) +
               1e-6 * float(half))
    for col, delta in ((4, 2 * measure.QUAD_TOL * scale), (0, 2 * com_tol)):
        bad = want.clone()
        bad[row, col] += delta
        with pytest.raises(AssertionError):
            measure.pyramid_close("moved", bad, want, pos_s, mass_s, **kw)
    bad = want.clone()
    bad[n // leaf + 1, 0] += 1.0
    with pytest.raises(AssertionError, match="mass 0"):
        measure.pyramid_close("empty", bad, want, pos_s, mass_s, **kw)
