"""The CUDA kernels K1 (near field), K2 (octet far field), K3 (all-pairs)
and K4 (gather far field) on the card, on dense and staged lists, and the
sectioned and staged paths through them; K5-K7, the tensor-core all-pairs
kernels of tools/mxu_allpairs.py, at both precisions; K8-K11, the
near-field experiments of tools/near_kernel_probe.py and
tools/flat_kernel.py, against their plain versions and against K1.

Every test here is marked `gpu` and skips where torch.cuda.is_available()
is False. The file imports neither JAX nor the JAX package, so it also runs
on a machine that has the card and no JAX; tests/conftest.py imports JAX,
so run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs are the port's own ICs, trees and lists (dense and staged, octet
and gather), built on the CPU; the plain PyTorch versions of the kernels
are the reference.
Tolerance rtol 2e-4, atol 2e-5 (the bound of tests/test_bh.py for the
Pallas kernels against their jnp versions): kernel and plain version sum
the same f32 terms in another order, with another rsqrt.
"""

import dataclasses

import numpy as np
import pytest
import torch

from parallelnbody_tpu_torch import Simulation, SimConfig
from parallelnbody_tpu_torch.api import init_simulation
from parallelnbody_tpu_torch.kernels import launch
from parallelnbody_tpu_torch.ops import bh, bh_kernels, direct_kernels
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
LEAF = 64

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lists(cuda):
    """Sorted particles, target leaves and dense-octet lists (quadrupole
    node table) at N = 8192, leaf 64, on the card."""
    cfg = SimConfig(n=8192, ic="plummer", seed=3)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=LEAF, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // LEAF
    far, rej = bh.traverse(tree, 0.6)
    ni, nv, fk, fv, nodes8, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=0.6, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0
    out = dict(pos_s=pos_s, mass_s=mass_s,
               tgt=pos_s.reshape(n_leaves, LEAF, 3), ni=ni, nv=nv, fk=fk,
               fv=fv, nodes8=nodes8)
    return {k: v.contiguous().to(cuda) for k, v in out.items()}


@pytest.fixture(scope="module")
def gather_lists(cuda):
    """Gather lists (quadrupole node tables) at N = 8192, leaf 16 (512
    leaves), theta 0.72, where both far classes hold entries, on the card."""
    cfg = SimConfig(n=8192, ic="plummer", seed=3)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, _, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=16, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // 16
    far, rej = bh.traverse(tree, 0.72)
    _, _, f0i, f0v, upi, upv, nodes_up, leaf_nodes, of = \
        bh.build_interaction_lists(tree, far, rej, theta=0.72, start_leaf=0,
                                   n_slice=n_leaves, near_budget=n_leaves,
                                   far0_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0 and bool(upv.any()) and bool(f0v.any())
    out = dict(tgt=pos_s.reshape(n_leaves, 16, 3), f0i=f0i, f0v=f0v,
               upi=upi, upv=upv, nodes_up=nodes_up, leaf_nodes=leaf_nodes)
    return {k: v.contiguous().to(cuda) for k, v in out.items()}


def _close(got, want):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_kernel_matches_plain(lists, softening, compute_pot):
    L = lists
    args = (L["pos_s"], L["mass_s"], L["tgt"], L["ni"], L["nv"])
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    before = bh_kernels.LAUNCHES["near_field"]
    acc, pot = bh_kernels.near_field(*args, **kw)
    assert bh_kernels.LAUNCHES["near_field"] == before + 1
    acc_p, pot_p = bh_kernels.near_field_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    assert bool(torch.any(pot != 0)) == compute_pot


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
def test_far_octet_kernel_matches_plain(lists, softening, compute_pot, quad):
    L = lists
    nodes8 = L["nodes8"] if quad else L["nodes8"][:, :4].contiguous()
    args = (L["tgt"], nodes8, L["fk"], L["fv"])
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    before = bh_kernels.LAUNCHES["far_octet"]
    acc, pot = bh_kernels.far_octet(*args, **kw)
    assert bh_kernels.LAUNCHES["far_octet"] == before + 1
    acc_p, pot_p = bh_kernels.far_octet_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    assert bool(torch.any(pot != 0)) == compute_pot


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("n_i,n_j", [(8192, 8192), (1000, 1000), (333, 700),
                                     (1, 7), (1500, 5000)],
                         ids=["square", "odd", "rect", "tiny", "ragged"])
def test_allpairs_kernel_matches_plain(lists, softening, compute_pot, n_i,
                                       n_j):
    """K3 at tile multiples (the sources cut into ranges whose partial
    sums are added in order), at an odd N (a ragged last tile and a block
    only partly filled with targets), with targets != sources, with one
    target against fewer sources than a tile, and with ranges over a
    ragged last tile."""
    pos, mass = lists["pos_s"], lists["mass_s"]
    args = (pos[:n_i].contiguous(), pos[-n_j:].contiguous(),
            mass[-n_j:].contiguous())
    kw = dict(softening=softening, compute_pot=compute_pot)
    before = direct_kernels.LAUNCHES["allpairs"]
    out = direct_kernels.allpairs(*args, **kw)
    assert direct_kernels.LAUNCHES["allpairs"] == before + 1
    _close(out, direct_kernels.allpairs_plain(*args, **kw))
    assert bool(torch.any(out[:, 3] != 0)) == compute_pot


def _sym_n():
    """The N of the self-gravity form's card tests: one and two particles,
    under one tile, one tile less one and exactly, three tiles and 5,
    an odd and an even tile count around N_SYM (each 3 short of full),
    and the main path's 262144."""
    t = direct_kernels.N_SYM // direct_kernels.SYM_TILE
    odd, even = (t, t + 1) if t % 2 else (t + 1, t)
    return [1, 2, 1000, 2047, 2048, 2048 * 3 + 5,
            odd * direct_kernels.SYM_TILE - 3,
            even * direct_kernels.SYM_TILE - 3, 262144]


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("n", _sym_n())
def test_allpairs_self_matches_plain_and_cross(cuda, monkeypatch, n,
                                              softening, compute_pot):
    """K3's self-gravity form (allpairs_self with N_SYM lowered to 1, so
    that it runs at every N) against the float64 plain version (at N =
    262144 on 2048 sampled targets) and against the cross form
    allpairs(pos, pos, mass), with every 7th particle from the 4th
    massless; one
    launch a call; a lone particle's potential is its own m / eps."""
    monkeypatch.setattr(direct_kernels, "N_SYM", 1)
    state = init_simulation(SimConfig(n=max(n, 2), ic="plummer", seed=n),
                            "cpu", compute_forces=False)
    pos = state.pos[:n].contiguous().to(cuda)
    mass = state.mass[:n].clone()
    mass[3::7] = 0.0
    mass = mass.to(cuda)
    kw = dict(softening=softening, compute_pot=compute_pot)
    before = direct_kernels.LAUNCHES["allpairs"]
    got = direct_kernels.allpairs_self(pos, mass, **kw)
    assert direct_kernels.LAUNCHES["allpairs"] == before + 1
    _close(got, direct_kernels.allpairs(pos, pos, mass, **kw))
    rows = (torch.linspace(0, n - 1, 2048, device=cuda).long()
            if n > 65536 else torch.arange(n, device=cuda))
    want = direct_kernels.allpairs_plain(pos[rows].double(), pos.double(),
                                         mass.double(), **kw)
    _close(got[rows], want.float())
    assert bool(torch.isfinite(got).all())
    if n == 1:
        pot = float(mass[0]) / softening if compute_pot and softening else 0
        np.testing.assert_allclose(got.cpu().numpy(), [[0, 0, 0, pot]],
                                   rtol=1e-6)


def test_allpairs_self_one_launch_two_kernels(cuda):
    """At N = 262144 allpairs_self runs the self-gravity form: one counted
    launch, k3.pairs N^2 and k3.sym_pairs the plan's evaluations, and a
    whole profiler reading of the call holds one allpairs_kernel record,
    one allpairs_combine_kernel and no other device record (up to three
    readings, as tools/measure.busy_ms takes them)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from parallelnbody_tpu_torch.kernels import launch

    n = 262144
    state = init_simulation(SimConfig(n=n, ic="plummer", seed=9), cuda,
                            compute_forces=False)
    kw = dict(softening=0.01, compute_pot=False)
    direct_kernels.allpairs_self(state.pos, state.mass, **kw)  # warm-up
    torch.cuda.synchronize()
    for _ in range(3):
        before, counted = launch.read_counters(), dict(direct_kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            direct_kernels.allpairs_self(state.pos, state.mass, **kw)
            torch.cuda.synchronize()
        after = launch.read_counters()
        assert direct_kernels.LAUNCHES["allpairs"] == counted["allpairs"] + 1
        assert after["k3.pairs"] - before["k3.pairs"] == n * n
        assert (after["k3.sym_pairs"] - before["k3.sym_pairs"]
                == direct_kernels.sym_pairs(n))
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(re.search(r"\ballpairs_kernel\b", x) for x in names):
            break
    assert sum(bool(re.search(r"\ballpairs_kernel\b", x))
               for x in names) == 1, names
    assert sum("allpairs_combine_kernel" in x for x in names) == 1, names
    assert len(names) == 2, names
    below = direct_kernels.N_SYM - 1
    small = init_simulation(SimConfig(n=below, ic="plummer", seed=9), cuda,
                            compute_forces=False)
    before = launch.read_counters()["k3.sym_pairs"]
    direct_kernels.allpairs_self(small.pos, small.mass, **kw)
    assert launch.read_counters()["k3.sym_pairs"] == before


def test_allpairs_self_momentum_no_worse_than_cross(cuda):
    """The self-gravity form adds each pair's two forces from one d and
    one u^3: at the main path's N = 262144, |sum m_i a_i| (float64 over its
    float32 output) is no larger than the cross form's on the same Plummer
    sphere (1.2e-9-3.3e-9 against 3.0e-8-1.3e-7 on five seeds)."""
    n = 262144
    state = init_simulation(SimConfig(n=n, ic="plummer", seed=11), cuda,
                            compute_forces=False)
    kw = dict(softening=0.01, compute_pot=False)
    m = state.mass.double()[:, None]
    sym = direct_kernels.allpairs_self(state.pos, state.mass, **kw)
    cross = direct_kernels.allpairs(state.pos, state.pos, state.mass, **kw)
    p_sym = (m * sym[:, :3].double()).sum(0).norm().item()
    p_cross = (m * cross[:, :3].double()).sum(0).norm().item()
    assert p_sym <= p_cross, (p_sym, p_cross)


@pytest.fixture(scope="module")
def uneven_lists(lists):
    """A synthetic near list over the N = 8192 particles (128 source
    leaves of 64) shaped like the N = 1M t = 0 lists' extremes: one row of
    1164 entries (source leaves repeat) among short rows, empty rows and
    rows of exactly NEAR_CHUNK entries and one more, budget 1536."""
    n_src = lists["pos_s"].shape[0] // LEAF
    chunk = bh_kernels.NEAR_CHUNK
    counts = [5, 0, 1164, chunk, 0, chunk + 1, 37, 2 * chunk, 1, 0]
    gen = torch.Generator(device="cpu").manual_seed(11)
    idx = torch.zeros((len(counts), 1536), dtype=torch.int32)
    for row, c in enumerate(counts):
        idx[row, :c] = torch.randint(0, n_src, (c,), generator=gen)
    valid = torch.arange(1536)[None, :] < torch.tensor(counts)[:, None]
    tgt_rows = torch.arange(len(counts)) * 11 % n_src
    return (lists["pos_s"], lists["mass_s"],
            lists["tgt"][tgt_rows.to(lists["tgt"].device)].contiguous(),
            idx.cuda(), valid.cuda())


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_kernel_uneven_rows(uneven_lists, softening, compute_pot):
    """K1's work items: a row cut into 37 items, rows of one item, and
    empty rows (zeros), against near_field_plain."""
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    acc, pot = bh_kernels.near_field(*uneven_lists, **kw)
    acc_p, pot_p = bh_kernels.near_field_plain(*uneven_lists, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    empty = ~uneven_lists[4].any(1).repeat_interleave(LEAF)
    assert bool((acc[empty] == 0).all()) and bool((pot[empty] == 0).all())


@pytest.mark.parametrize("targets", ["one_way", "mutual"])
@pytest.mark.parametrize("leaf", [16, 128, 256])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_kernel_leaf_sizes(cuda, leaf, compute_pot, targets):
    """K1 holds 1, 4 and 8 targets a thread at leaf 16, 128 and 256 (a
    block is one warp from leaf 128 on), in both forms on whole-set
    lists: targets held apart from the sources (a copy: the one-way
    form) and targets that are the sources (a view of pos_s: the mutual
    form); the work items built beforehand (near_work, as the paths build
    them) give the same bits as items built inside the call."""
    cfg = SimConfig(n=8192, ic="plummer", seed=4)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // leaf
    far, rej = bh.traverse(tree, 0.6)
    ni, nv, *_, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=0.6, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0
    pos_c = pos_s.contiguous().to(cuda)
    tgt = pos_c.reshape(n_leaves, leaf, 3)
    if targets == "one_way":
        tgt = tgt.clone()
    args = (pos_c, mass_s.contiguous().to(cuda), tgt,
            ni.contiguous().to(cuda), nv.contiguous().to(cuda))
    kw = dict(g=1.5, softening=0.02, compute_pot=compute_pot)
    acc, pot = bh_kernels.near_field(*args, **kw)
    acc_p, pot_p = bh_kernels.near_field_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    if targets == "one_way":
        work = bh_kernels.near_work(args[4])
        assert work.pairs is None
    else:
        work = bh_kernels.near_work(args[4], args[3],
                                    sources=(n_leaves, leaf))
        assert work.pairs is not None and work.sym_entries > 0
    acc_w, pot_w = bh_kernels.near_field(*args, work=work, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_w) and torch.equal(pot, pot_w)


@pytest.fixture(scope="module", params=[16, 128, 256],
                ids=lambda g: f"leaf{g}")
def whole_lists(cuda, request):
    """Whole-set staged near lists (theta 0.72, as the Barnes-Hut cells)
    of a Plummer sphere at leaf 16, 128 and 256, on the card; the target
    leaves are a view of the sorted particles, so K1 takes its mutual
    form."""
    leaf = request.param
    cfg = SimConfig(n=32768, ic="plummer", seed=6)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // leaf
    widths = [c.shape[0] for c in tree.com]
    far, rej = bh.traverse(tree, 0.72, stop_level=2)
    ni, nv, *_, of = bh.build_interaction_lists_staged(
        tree, far, rej, theta=0.72, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=2 * n_leaves,
        cand2_budget=widths[2], cand1_budget=widths[1],
        dtype=torch.float32, octet_far=True)
    assert int(of) == 0
    pos_c = pos_s.contiguous().to(cuda)
    return dict(pos_s=pos_c, mass_s=mass_s.contiguous().to(cuda),
                tgt=pos_c.reshape(n_leaves, leaf, 3),
                ni=ni.contiguous().to(cuda), nv=nv.contiguous().to(cuda),
                leaf=leaf)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_mutual_form_matches_plain(whole_lists, softening,
                                              compute_pot):
    """K1's mutual form (each mutual leaf pair once, added to both leaves)
    against near_field_plain at leaf 16, 128 and 256: one launch, and
    k1.sym_terms counts the mutual entries x G^2 beside k1.pair_terms'
    entries x G^2."""
    W = whole_lists
    G = W["leaf"]
    args = (W["pos_s"], W["mass_s"], W["tgt"], W["ni"], W["nv"])
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    work = bh_kernels.near_work(W["nv"], W["ni"],
                                sources=(W["tgt"].shape[0], G))
    assert work.pairs is not None and work.pairs.shape[0] > 0
    want = bh_kernels.near_pairs(W["ni"].cpu(), W["nv"].cpu())
    assert work.sym_entries == want.sym_entries > 0
    assert work.entries == int(W["nv"].sum())
    before = launch.read_counters()
    launches = bh_kernels.LAUNCHES["near_field"]
    acc, pot = bh_kernels.near_field(*args, work=work, **kw)
    after = launch.read_counters()
    assert bh_kernels.LAUNCHES["near_field"] == launches + 1
    assert after["k1.sym_terms"] - before["k1.sym_terms"] == \
        work.sym_entries * G * G
    assert after["k1.pair_terms"] - before["k1.pair_terms"] == \
        work.entries * G * G
    acc_p, pot_p = bh_kernels.near_field_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    assert bool(torch.any(pot != 0)) == compute_pot
    # Built inside the call: the same items, the same bits.
    acc_c, pot_c = bh_kernels.near_field(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_c) and torch.equal(pot, pot_c)


@pytest.mark.parametrize("cut", ["whole", "cut_rows"])
@pytest.mark.parametrize("chunk", [bh_kernels.NEAR_CHUNK, 5])
def test_mutual_items_on_the_card_are_the_plain_pairing(whole_lists, cut,
                                                         chunk):
    """near_pairs on the card (csrc/near_pairs.cu) builds the torch
    version's work item for item: kinds, served sources, slots, items and
    mutual items in their order, splits and sizes, and the clip counter
    read with them; on the whole-set lists and on lists with empty rows
    and rows cut short (one-sided entries), at two item lengths; two
    launches a build."""
    W = whole_lists
    ni, nv = W["ni"], W["nv"].clone()
    if cut == "cut_rows":
        rows = torch.arange(nv.shape[0], device=nv.device)
        nv[rows % 3 == 0] = False
        nv[(rows % 5 == 1)[:, None] & (torch.arange(
            nv.shape[1], device=nv.device) >= 7)] = False
    overflow = torch.tensor(7, dtype=torch.int64, device=nv.device)
    launches = bh_kernels.PAIR_LAUNCHES["near_pairs"]
    got = bh_kernels.near_pairs(ni, nv, chunk=chunk, overflow=overflow)
    assert bh_kernels.PAIR_LAUNCHES["near_pairs"] == launches + 2
    want = bh_kernels.near_pairs(ni.cpu(), nv.cpu(), chunk=chunk,
                                 overflow=overflow.cpu())
    for name in ("items", "splits", "srcs", "slot_of", "pairs"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    for name in ("n_partial", "entries", "sym_entries", "chunk", "r",
                 "overflow"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.overflow == 7 and got.sym_entries > 0


def test_mutual_items_wait_on_the_host_once(whole_lists):
    """near_pairs reads its sizes (and a clip counter beside them) in one
    host_read and builds the items at those sizes with no other wait on
    the card."""
    import warnings

    W = whole_lists
    overflow = torch.zeros((), dtype=torch.int64, device=W["nv"].device)
    before = launch.read_counters()["host_reads"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            work = bh_kernels.near_pairs(W["ni"], W["nv"], overflow=overflow)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert launch.read_counters()["host_reads"] == before + 1
    assert work.overflow == 0 and work.sym_entries > 0


def test_mutual_form_only_on_whole_set_lists(whole_lists):
    """The mutual form engages only where the lists cover every leaf and
    the targets are the sources: the window and table forms, a target
    window's rows, an out= call and targets held apart from pos_s keep the
    one-way form and count no k1.sym_terms; a mutual work is refused
    there."""
    W = whole_lists
    G = W["leaf"]
    n_leaves = W["tgt"].shape[0]
    kw = dict(g=1.0, softening=0.02)
    table = torch.cat([W["pos_s"], W["mass_s"][:, None]], 1).contiguous()
    half = n_leaves // 2
    calls = {
        "window": lambda: bh_kernels.near_field(
            W["pos_s"], W["mass_s"], W["tgt"], W["ni"], W["nv"], leaf_lo=0,
            **kw),
        "table": lambda: bh_kernels.near_field(
            None, None, W["tgt"], W["ni"], W["nv"], src_table=table, **kw),
        "rows": lambda: bh_kernels.near_field(
            W["pos_s"], W["mass_s"], W["tgt"][:half], W["ni"][:half],
            W["nv"][:half], **kw),
        "out": lambda: bh_kernels.near_field(
            W["pos_s"], W["mass_s"], W["tgt"], W["ni"], W["nv"],
            out=(torch.zeros_like(W["pos_s"]), torch.zeros_like(
                W["mass_s"])), **kw),
        "copy": lambda: bh_kernels.near_field(
            W["pos_s"], W["mass_s"], W["tgt"].clone(), W["ni"], W["nv"],
            **kw),
    }
    for name, call in calls.items():
        before = launch.read_counters()["k1.sym_terms"]
        call()
        assert launch.read_counters()["k1.sym_terms"] == before, name
    assert bh_kernels.near_work(W["nv"][:half], W["ni"][:half],
                                sources=(n_leaves, G)).pairs is None
    assert bh_kernels.near_work(W["nv"], W["ni"], (0, n_leaves),
                                sources=(n_leaves, G)).pairs is None
    work = bh_kernels.near_work(W["nv"], W["ni"], sources=(n_leaves, G))
    with pytest.raises(ValueError, match="whole-set"):
        bh_kernels.near_field(W["pos_s"], W["mass_s"], W["tgt"].clone(),
                              W["ni"], W["nv"], work=work, **kw)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("kernel", ["near_field", "allpairs", "far_octet",
                                    "far_gather", "allpairs_self",
                                    "near_field_mutual", "near_field_window",
                                    "near_field_table"])
def test_pair_kernels_repeat_bit_equal(lists, uneven_lists, gather_lists,
                                       monkeypatch, kernel, softening):
    """K1-K4 take no float atomics: two launches on the same inputs give the
    same bits (K1 in its one-way form, its mutual form on whole-set lists,
    its window form and its table form, K3 in its cross and its
    self-gravity form, the latter at N = 8192 below N_SYM by lowering
    N_SYM)."""
    kw = dict(g=1.0, softening=softening)
    if kernel == "near_field":
        def run():
            return bh_kernels.near_field(*uneven_lists, **kw)
    elif kernel == "near_field_mutual":
        L = lists
        tgt = L["pos_s"].reshape(L["tgt"].shape)

        def run():
            before = launch.read_counters()["k1.sym_terms"]
            out = bh_kernels.near_field(L["pos_s"], L["mass_s"], tgt,
                                        L["ni"], L["nv"], **kw)
            assert launch.read_counters()["k1.sym_terms"] > before
            return out
    elif kernel == "near_field_window":
        L = lists
        half = L["pos_s"].shape[0] // 2

        def run():
            return bh_kernels.near_field(
                L["pos_s"][half:].contiguous(),
                L["mass_s"][half:].contiguous(), L["tgt"], L["ni"], L["nv"],
                leaf_lo=half // LEAF, **kw)
    elif kernel == "near_field_table":
        L = lists
        table = torch.cat([L["pos_s"], L["mass_s"][:, None]], 1).contiguous()

        def run():
            return bh_kernels.near_field(None, None, L["tgt"], L["ni"],
                                         L["nv"], src_table=table, **kw)
    elif kernel == "allpairs":
        pos, mass = lists["pos_s"], lists["mass_s"]

        def run():
            return (direct_kernels.allpairs(pos, pos, mass,
                                            softening=softening),)
    elif kernel == "allpairs_self":
        pos, mass = lists["pos_s"], lists["mass_s"]
        monkeypatch.setattr(direct_kernels, "N_SYM", 1)

        def run():
            return (direct_kernels.allpairs_self(pos, mass,
                                                 softening=softening),)
    elif kernel == "far_octet":
        L = lists

        def run():
            return bh_kernels.far_octet(L["tgt"], L["nodes8"], L["fk"],
                                        L["fv"], **kw)
    else:
        G = gather_lists

        def run():
            return bh_kernels.far_gather(G["tgt"], G["leaf_nodes"], G["f0i"],
                                         G["f0v"], **kw)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_rebuild_interval_plan_holds_the_work_items(cuda):
    """bh_plan_lists builds K1's work items and K2's launch order once with
    the lists, so the frozen lists' evaluations wait on the host and sort
    no more; one window's lists cover every leaf, so K1's items are the
    mutual form's."""
    cfg = SimConfig(n=4096, ic="plummer", seed=2)
    state = init_simulation(cfg, cuda, compute_forces=False)
    pos_s, mass_s, _, tree, _, _ = bh._prepare(
        state.pos, state.mass, leaf_size=LEAF, curve="hilbert",
        multipole_order=2)
    plan = bh.bh_plan_lists(tree, theta=0.6, near_budget=64, far_budget=64,
                            refine="dense", cand_budgets=(0, 0),
                            dtype=torch.float32, leaf_size=LEAF)
    assert int(plan.overflow) == 0
    want = bh_kernels.near_work(plan.near_valid, plan.near_idx,
                                sources=(plan.near_idx.shape[0], LEAF))
    assert plan.near_work is not None and len(plan.near_work) == 1
    (work,), (order,) = plan.near_work, plan.far_order
    assert work.pairs is not None and work.sym_entries == want.sym_entries
    for name in ("items", "splits", "pairs", "srcs", "slot_of"):
        assert torch.equal(getattr(work, name), getattr(want, name)), name
    assert work.n_partial == want.n_partial
    assert torch.equal(order, bh_kernels.far_order(plan.far_valid))


@pytest.mark.parametrize("kernel", ["far_octet", "far_gather"])
def test_far_kernels_give_the_same_bits_in_any_launch_order(
        lists, gather_lists, kernel):
    """K2 and K4 run their target leaves longest list first; a leaf's sums
    never leave its block, so the order built with the lists, the one the
    wrapper builds, the identity and a reversed order give the same bits."""
    if kernel == "far_octet":
        L = lists
        args, valid = (L["tgt"], L["nodes8"], L["fk"], L["fv"]), L["fv"]
        fn = bh_kernels.far_octet
    else:
        G = gather_lists
        args = (G["tgt"], G["leaf_nodes"], G["f0i"], G["f0v"])
        valid, fn = G["f0v"], bh_kernels.far_gather
    n = valid.shape[0]
    ident = torch.arange(n, dtype=torch.int32, device="cuda")
    kw = dict(g=1.0, softening=0.02)
    want = fn(*args, **kw)
    for order in (bh_kernels.far_order(valid), ident, ident.flip(0)):
        got = fn(*args, order=order.contiguous(), **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):  # an order must name every leaf
        fn(*args, order=ident[:-1], **kw)
    with pytest.raises(ValueError):  # on the lists' device
        fn(*args, order=ident.cpu(), **kw)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
@pytest.mark.parametrize("cls", ["upper", "leaf"])
def test_far_gather_kernel_matches_plain(gather_lists, softening, compute_pot,
                                         quad, cls):
    L = gather_lists
    table, idx, valid = ((L["nodes_up"], L["upi"], L["upv"]) if cls == "upper"
                         else (L["leaf_nodes"], L["f0i"], L["f0v"]))
    table = table if quad else table[:, :4].contiguous()
    args = (L["tgt"], table, idx, valid)
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    before = bh_kernels.LAUNCHES["far_gather"]
    acc, pot = bh_kernels.far_gather(*args, **kw)
    assert bh_kernels.LAUNCHES["far_gather"] == before + 1
    acc_p, pot_p = bh_kernels.far_gather_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    assert bool(torch.any(pot != 0)) == compute_pot


def test_far_gather_kernel_scattered_mask(gather_lists):
    """front_packed=False: a random third of the leaf table's rows per
    target, unpacked; the kernel walks and masks every entry."""
    L = gather_lists
    n_leaves = L["tgt"].shape[0]
    gen = torch.Generator(device="cpu").manual_seed(4)
    valid = (torch.rand((n_leaves, n_leaves), generator=gen) < 1 / 3).cuda()
    idx = torch.arange(n_leaves, dtype=torch.int32, device="cuda")
    idx = idx[None].expand(n_leaves, n_leaves).contiguous()
    args = (L["tgt"], L["leaf_nodes"], idx, valid)
    kw = dict(g=1.0, softening=0.02)
    acc, pot = bh_kernels.far_gather(*args, front_packed=False, **kw)
    acc_p, pot_p = bh_kernels.far_gather_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)


@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
def test_far_gather_kernel_scattered_late_entries(gather_lists, quad):
    """front_packed=False with no valid entry in the first 100 of a row (the
    first windows the kernel stages are empty), a row with one valid entry
    at its last column, an empty row, and rows valid from entry 100 on."""
    L = gather_lists
    table = L["leaf_nodes"] if quad else L["leaf_nodes"][:, :4].contiguous()
    n_leaves = L["tgt"].shape[0]
    gen = torch.Generator(device="cpu").manual_seed(6)
    valid = torch.rand((n_leaves, n_leaves), generator=gen) < 0.5
    valid[:, :100] = False
    valid[0] = False
    valid[0, -1] = True
    valid[1] = False
    idx = torch.randperm(n_leaves, generator=gen).to(torch.int32)
    idx = idx[None].expand(n_leaves, n_leaves).contiguous()
    args = (L["tgt"], table, idx.cuda(), valid.cuda())
    kw = dict(g=1.0, softening=0.02, compute_pot=True)
    acc, pot = bh_kernels.far_gather(*args, front_packed=False, **kw)
    acc_p, pot_p = bh_kernels.far_gather_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    leaf = L["tgt"].shape[1]
    assert bool((acc[leaf:2 * leaf] == 0).all())
    assert bool((acc[:leaf] != 0).any())


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
def test_far_octet_kernel_child_masks(lists, softening, quad):
    """K2 expands only the accepted children of a key: rows of keys whose
    masks are all 0x01, all 0x80 or all 0xff (20 full octets, so the dense
    rows cross buffer boundaries), a row of three keys whose children do
    not fill one buffer, and an empty row, against far_octet_plain."""
    L = lists
    nodes8 = L["nodes8"] if quad else L["nodes8"][:, :4].contiguous()
    n_oct = nodes8.shape[0] // 8
    gen = torch.Generator(device="cpu").manual_seed(8)
    budget = 24
    rows = []
    for mask, count in ((0x01, 24), (0x80, 24), (0xFF, 20), (None, 3),
                        (0x01, 0)):
        octs = torch.sort(torch.randint(0, n_oct, (count,),
                                        generator=gen)).values
        masks = (torch.randint(1, 256, (count,), generator=gen)
                 if mask is None else torch.full((count,), mask))
        row = torch.full((budget,), 2**31 - 1, dtype=torch.int32)
        row[:count] = ((octs << 8) | masks).to(torch.int32)
        rows.append(row)
    keys = torch.stack(rows).cuda()
    valid = keys != 2**31 - 1
    tgt = L["tgt"][torch.arange(len(rows), device="cuda") * 7].contiguous()
    kw = dict(g=1.5, softening=softening, compute_pot=True)
    acc, pot = bh_kernels.far_octet(tgt, nodes8, keys, valid, **kw)
    acc_p, pot_p = bh_kernels.far_octet_plain(tgt, nodes8, keys, valid, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    assert bool((acc[-LEAF:] == 0).all()) and bool((pot[-LEAF:] == 0).all())


@pytest.mark.parametrize("leaf", [128, 256])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_far_kernels_leaf_sizes(cuda, leaf, compute_pot):
    """K2 and K4 hold 4 and 8 targets a thread at leaf 128 and 256 (a
    block is one warp), on the port's octet and gather lists at N = 16384,
    theta 0.6, quadrupole tables."""
    cfg = SimConfig(n=16384, ic="plummer", seed=5)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, _, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // leaf
    far, rej = bh.traverse(tree, 0.6)
    *_, fk, fv, nodes8, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=0.6, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    _, _, f0i, f0v, upi, upv, nodes_up, leaf_nodes, of_g = \
        bh.build_interaction_lists(tree, far, rej, theta=0.6, start_leaf=0,
                                   n_slice=n_leaves, near_budget=n_leaves,
                                   far0_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0 and int(of_g) == 0 and bool(fv.any())
    tgt = pos_s.reshape(n_leaves, leaf, 3).contiguous().cuda()
    kw = dict(g=1.5, softening=0.02, compute_pot=compute_pot)
    cases = [(bh_kernels.far_octet, bh_kernels.far_octet_plain,
              (nodes8, fk, fv)),
             (bh_kernels.far_gather, bh_kernels.far_gather_plain,
              (nodes_up, upi, upv)),
             (bh_kernels.far_gather, bh_kernels.far_gather_plain,
              (leaf_nodes, f0i, f0v))]
    for kernel, plain, lists_ in cases:
        args = (tgt, *(t.contiguous().cuda() for t in lists_))
        acc, pot = kernel(*args, **kw)
        acc_p, pot_p = plain(*args, **kw)
        _close(acc, acc_p)
        _close(pot, pot_p)


def test_wrappers_refuse_what_the_kernels_do_not_take(lists, gather_lists):
    L, G = lists, gather_lists
    kw = dict(g=1.0, softening=0.02)
    with pytest.raises(TypeError):  # f64 on the card is refused, not cast
        bh_kernels.near_field(L["pos_s"].double(), L["mass_s"].double(),
                              L["tgt"].double(), L["ni"], L["nv"], **kw)
    with pytest.raises(TypeError):
        bh_kernels.far_octet(L["tgt"].double(), L["nodes8"].double(),
                             L["fk"], L["fv"], **kw)
    with pytest.raises(ValueError):  # non-contiguous lists
        bh_kernels.near_field(L["pos_s"], L["mass_s"], L["tgt"],
                              L["ni"].t().contiguous().t(), L["nv"], **kw)
    with pytest.raises(ValueError):  # tensors on two devices
        bh_kernels.far_octet(L["tgt"], L["nodes8"].cpu(), L["fk"], L["fv"],
                             **kw)
    with pytest.raises(TypeError):
        direct_kernels.allpairs(L["pos_s"].double(), L["pos_s"].double(),
                                L["mass_s"].double(), softening=0.02)
    with pytest.raises(TypeError):
        bh_kernels.far_gather(G["tgt"], G["leaf_nodes"].double(), G["f0i"],
                              G["f0v"], **kw)
    with pytest.raises(ValueError):  # non-contiguous sources
        direct_kernels.allpairs(L["pos_s"], L["pos_s"][::2], L["mass_s"][::2],
                                softening=0.02)


def test_simulation_runs_the_kernels(cuda):
    """Simulation on the card: the per-step path and a rebuild-interval
    run both launch K1 and K2, clip nothing, and stay in the accuracy
    class of the reference (sampled rms against the direct sum < 2e-3)."""
    cfg = SimConfig(n=32768, ic="plummer", force="barnes_hut", theta=0.72,
                    bh_leaf_size=64, dt=1e-3, track_potential=False)
    bh_kernels.reset_launch_counts()
    sim = Simulation(cfg, device="cuda")
    sim.step(1)
    sim.step(8)
    torch.cuda.synchronize()
    assert bh_kernels.LAUNCHES["near_field"] > 0
    assert bh_kernels.LAUNCHES["far_octet"] > 0
    assert int(sim.overflow) == 0
    s = sim.state
    assert int(s.step) == 9
    for t in (s.pos, s.vel, s.acc):
        assert bool(torch.isfinite(t).all())
    rms = rms_force_error_sample(s.pos, s.mass, s.acc, g=cfg.g,
                                 softening=cfg.softening, k=2048)
    assert rms < 2e-3


@pytest.mark.parametrize("change", [{"force": "direct_pallas"},
                                    {"bh_far_mode": "gather"}],
                         ids=["direct_pallas", "gather"])
def test_simulation_runs_the_new_paths(cuda, change):
    """force="direct_pallas" launches K3 only; bh_far_mode="gather" launches
    K4 and K1, clips nothing and stays in the reference's accuracy class."""
    cfg = SimConfig(**{**dict(n=32768, ic="plummer", force="barnes_hut",
                              theta=0.72, bh_leaf_size=64, dt=1e-3,
                              track_potential=False), **change})
    bh_kernels.reset_launch_counts()
    direct_kernels.reset_launch_counts()
    sim = Simulation(cfg, device="cuda")
    sim.step(1)
    sim.step(4)
    torch.cuda.synchronize()
    launched = {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}
    want = ({"allpairs"} if "force" in change
            else {"near_field", "far_gather"})
    assert {k for k, v in launched.items() if v > 0} == want
    assert int(sim.overflow) == 0
    s = sim.state
    assert int(s.step) == 5
    assert bool(torch.isfinite(s.acc).all())
    rms = rms_force_error_sample(s.pos, s.mass, s.acc, g=cfg.g,
                                 softening=cfg.softening, k=2048)
    assert rms < (1e-4 if "force" in change else 2e-3)


@pytest.fixture(scope="module")
def staged_lists(cuda):
    """Staged lists at N = 65536, leaf 32 (2048 leaves, five levels), theta
    0.6, quadrupole tables, on the card: the near list, the octet far list
    (keys from _octet_keys_children) and the gather far list over
    _nodes_all."""
    cfg = SimConfig(n=65536, ic="plummer", seed=6)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=32, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // 32
    widths = [c.shape[0] for c in tree.com]
    far, rej2 = bh.traverse(tree, 0.6, stop_level=2)
    kw = dict(theta=0.6, start_leaf=0, n_slice=n_leaves,
              near_budget=n_leaves, far_budget=4 * n_leaves,
              cand2_budget=widths[2], cand1_budget=widths[1],
              dtype=torch.float32)
    ni, nv, fk, fv, nodes8, of = bh.build_interaction_lists_staged(
        tree, far, rej2, octet_far=True, **kw)
    _, _, gi, gv, nodes_all, of_g = bh.build_interaction_lists_staged(
        tree, far, rej2, octet_far=False, **kw)
    assert int(of) == 0 and int(of_g) == 0
    out = dict(pos_s=pos_s, mass_s=mass_s,
               tgt=pos_s.reshape(n_leaves, 32, 3), ni=ni, nv=nv, fk=fk,
               fv=fv, nodes8=nodes8, gi=gi, gv=gv, nodes_all=nodes_all)
    return {k: v.contiguous().to(cuda) for k, v in out.items()}


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("kernel", ["near_field", "far_octet", "far_gather"])
def test_kernels_match_plain_on_staged_lists(staged_lists, kernel, softening,
                                             compute_pot):
    """K1 on the staged near lists, K2 on the staged octet keys (partial
    child masks built per parent), K4 on the one combined staged gather
    list, each launched once, against its plain version."""
    L = staged_lists
    fn, plain, args = {
        "near_field": (bh_kernels.near_field, bh_kernels.near_field_plain,
                       (L["pos_s"], L["mass_s"], L["tgt"], L["ni"], L["nv"])),
        "far_octet": (bh_kernels.far_octet, bh_kernels.far_octet_plain,
                      (L["tgt"], L["nodes8"], L["fk"], L["fv"])),
        "far_gather": (bh_kernels.far_gather, bh_kernels.far_gather_plain,
                       (L["tgt"], L["nodes_all"], L["gi"], L["gv"])),
    }[kernel]
    kw = dict(g=1.5, softening=softening, compute_pot=compute_pot)
    before = bh_kernels.LAUNCHES[kernel]
    acc, pot = fn(*args, **kw)
    assert bh_kernels.LAUNCHES[kernel] == before + 1
    acc_p, pot_p = plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    assert bool(torch.any(pot != 0)) == compute_pot


@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
def test_far_octet_kernel_duplicate_octets(lists, quad):
    """Rows naming one octet in several keys with disjoint masks (what two
    parents of branch factor < 8 emit in staged lists): K2 sums every
    entry, as one key of the union mask, and agrees with far_octet_plain."""
    L = lists
    nodes8 = L["nodes8"] if quad else L["nodes8"][:, :4].contiguous()
    n_oct = nodes8.shape[0] // 8
    big = 2**31 - 1
    rows_split, rows_union = [], []
    for r, masks in enumerate(([0x0F, 0xF0], [0x01, 0x02, 0x0C, 0xF0],
                               [0x55, 0xAA], [0x80, 0x7F])):
        o = (3 * r + 1) % n_oct
        other = (o + 5) % n_oct
        split = sorted([(o << 8) | m for m in masks] + [(other << 8) | 0x3C])
        union = sorted([(o << 8) | 0xFF, (other << 8) | 0x3C])
        rows_split.append(split + [big] * (6 - len(split)))
        rows_union.append(union + [big] * (6 - len(union)))
    keys = torch.tensor(rows_split, dtype=torch.int32, device="cuda")
    keys_u = torch.tensor(rows_union, dtype=torch.int32, device="cuda")
    tgt = L["tgt"][:4].contiguous()
    kw = dict(g=1.0, softening=0.02, compute_pot=True)
    acc, pot = bh_kernels.far_octet(tgt, nodes8, keys, keys != big, **kw)
    acc_p, pot_p = bh_kernels.far_octet_plain(tgt, nodes8, keys, keys != big,
                                              **kw)
    acc_u, pot_u = bh_kernels.far_octet(tgt, nodes8, keys_u, keys_u != big,
                                        **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    _close(acc, acc_u)
    _close(pot, pot_u)


@pytest.mark.parametrize("far_mode", ["octet", "gather"])
def test_sections_bitwise_on_the_card(cuda, far_mode):
    """bh_accel in 4 target windows against 2, staged, on the card: the
    same forces, potentials and overflow bit for bit, and against one
    window (whose whole-set lists take K1's mutual form, which rounds
    differently) to the kernels' tolerance; and rebuild-interval plans
    built in 4 and 2 windows evaluate to the same bits, and the one-window
    plan (mutual, as the runs build it) to the kernels' tolerance."""
    cfg = SimConfig(n=65536, ic="plummer", seed=7)
    state = init_simulation(cfg, cuda, compute_forces=False)
    # Budgets above this state's requirements (near 2043 of 2048 leaves,
    # far 246 octets or 1763 nodes, candidates 32 and 256).
    kw = dict(leaf_size=32, theta=0.6, g=1.0, softening=0.02,
              near_budget=2048, far0_budget=512 if far_mode == "octet"
              else 2048, multipole=2, refine="staged", far_mode=far_mode,
              cand_budgets=(64, 512))
    a1, p1, of1 = bh.bh_accel(state.pos, state.mass, sections=1, **kw)
    a2, p2, of2 = bh.bh_accel(state.pos, state.mass, sections=2, **kw)
    a4, p4, of4 = bh.bh_accel(state.pos, state.mass, sections=4, **kw)
    torch.cuda.synchronize()
    assert int(of1) == int(of2) == int(of4) == 0
    assert torch.equal(a2, a4) and torch.equal(p2, p4)
    _close(a1, a4)
    _close(p1, p4)
    if far_mode == "gather":
        return
    pos_s, mass_s, _, tree, _, _ = bh._prepare(
        state.pos, state.mass, leaf_size=32, curve="hilbert",
        multipole_order=2)
    pkw = dict(theta=0.6, near_budget=2048, far_budget=512, refine="staged",
               cand_budgets=(64, 512), dtype=torch.float32, leaf_size=32)
    ekw = dict(leaf_size=32, g=1.0, softening=0.02, multipole=2,
               max_levels=12, compute_pot=True, n_live=cfg.n)
    plans = {s: bh.bh_plan_lists(tree, sections=s, **pkw) for s in (1, 2, 4)}
    assert all(int(p.overflow) == 0 for p in plans.values())
    assert plans[1].near_work[0].pairs is not None
    assert len(plans[4].near_work) == len(plans[4].far_order) == 4
    e1, e2, e4 = (bh.bh_eval_lists(pos_s, mass_s, plans[s], sections=s,
                                   **ekw) for s in (1, 2, 4))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(e2, e4))
    for a, b in zip(e1, e4):
        _close(a, b)


@pytest.mark.parametrize("case", ["staged", "staged_gather",
                                  "galaxy_collision"])
def test_simulation_runs_staged_paths(cuda, case):
    """Staged refinement through Simulation on the card: the octet path
    launches K1 and K2, the gather path K1 and K4, and the galaxy
    collision (auto leaf, staged, potential on) K1 and K2; nothing
    clips, the state stays finite and the sampled rms force error stays
    below 2e-3."""
    base = dict(n=65536, ic="plummer", force="barnes_hut", theta=0.72,
                bh_leaf_size=32, dt=1e-3, track_potential=False,
                bh_refine="staged")
    change = {"staged": {},
              "staged_gather": {"bh_far_mode": "gather"},
              "galaxy_collision": {"ic": "galaxy_collision",
                                   "track_potential": True}}[case]
    cfg = SimConfig(**{**base, **change})
    bh_kernels.reset_launch_counts()
    sim = Simulation(cfg, device="cuda")
    assert sim.cfg.bh_cand2_budget > 0 and sim.cfg.bh_cand_budget > 0
    sim.step(1)
    sim.step(4)
    torch.cuda.synchronize()
    launched = {k for k, v in bh_kernels.LAUNCHES.items() if v > 0}
    assert launched == ({"near_field", "far_gather"} if case ==
                        "staged_gather" else {"near_field", "far_octet"})
    assert int(sim.overflow) == 0
    s = sim.state
    assert int(s.step) == 5
    for t in (s.pos, s.vel, s.acc):
        assert bool(torch.isfinite(t).all())
    rms = rms_force_error_sample(s.pos, s.mass, s.acc, g=cfg.g,
                                 softening=cfg.softening, k=2048)
    assert rms < 2e-3


def test_cli_run_resume_on_the_card(cuda, tmp_path, capsys):
    """The command line on the card: a Barnes-Hut run at rebuild 8 launches
    K1 and K2, and a run checkpointed at step 16 and resumed to 32 equals
    an uninterrupted 32-step run bit for bit (no kernel uses float
    atomics)."""
    from parallelnbody_tpu_torch.cli import main
    from parallelnbody_tpu_torch.utils.io import (latest_checkpoint,
                                                  load_checkpoint)

    common = ["run", "--device", "cuda", "--n", "16384", "--force",
              "barnes_hut", "--dt", "0.001", "--quiet", "--log-every", "8",
              "--checkpoint-every", "16"]
    bh_kernels.reset_launch_counts()
    assert main(common + ["--steps", "16", "--checkpoint-dir",
                          str(tmp_path / "a")]) == 0
    assert bh_kernels.LAUNCHES["near_field"] > 0
    assert bh_kernels.LAUNCHES["far_octet"] > 0
    assert main(common + ["--steps", "16", "--resume", "--checkpoint-dir",
                          str(tmp_path / "a")]) == 0
    assert main(common + ["--steps", "32", "--checkpoint-dir",
                          str(tmp_path / "b")]) == 0
    capsys.readouterr()
    a, _ = load_checkpoint(latest_checkpoint(tmp_path / "a"), cuda)
    b, _ = load_checkpoint(latest_checkpoint(tmp_path / "b"), cuda)
    assert int(a.step) == int(b.step) == 32
    for name in ("pos", "vel", "acc", "pot", "time"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("n,method", [(65536, "direct_pallas"),
                                      (196608, "barnes_hut")])
def test_auto_force_on_the_card(cuda, n, method):
    """force="auto" on the card: K3 below its crossover, Barnes-Hut from
    it, and make_run drives the same kernel as make_step."""
    from parallelnbody_tpu_torch.api import make_run

    cfg = SimConfig(n=n)
    assert cfg.resolve_force(cuda) == method
    sim = Simulation(cfg, device=cuda)
    direct_kernels.reset_launch_counts()
    bh_kernels.reset_launch_counts()
    make_run(sim.cfg, 2)(sim.state)
    torch.cuda.synchronize()
    launched = {**direct_kernels.LAUNCHES, **bh_kernels.LAUNCHES}
    want = "allpairs" if method == "direct_pallas" else "near_field"
    assert launched[want] > 0, launched


def test_simulation_resolves_the_card_leaf(cuda):
    """Simulation(SimConfig(n=2^20)) on the card resolves the auto leaf by
    the card's rule (128, where the CPU's gives 256), calibrates and steps
    at it (per step and one rebuild block) with nothing clipped."""
    cfg = SimConfig(n=1 << 20)
    sim = Simulation(cfg, device=cuda)
    assert sim.cfg.bh_leaf_size == cfg.resolve_bh_leaf_size("cuda") == 128
    assert sim.cfg.resolve_bh_refine() == cfg.resolve_bh_refine("cuda")
    sim.step(1)
    sim.step(8)
    torch.cuda.synchronize()
    assert int(sim.overflow) == 0
    assert bool(torch.isfinite(sim.state.acc).all())


# ------------------------------------------ K1's window and table forms
@pytest.mark.parametrize("n_sh", [1, 4])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_window_form_matches_plain(lists, n_sh, compute_pot):
    """K1's window form (leaf_lo=) on each shard of the sorted particles
    against its plain version (on its own items, shaped by the window's
    work); with one shard over every leaf and the unwindowed form's items,
    bit for bit the unwindowed form."""
    L = lists
    n_leaves = L["tgt"].shape[0]
    nl = n_leaves // n_sh
    kw = dict(g=1.5, softening=0.02, compute_pot=compute_pot)
    total = None
    for s in range(n_sh):
        rows = slice(s * nl * LEAF, (s + 1) * nl * LEAF)
        args = (L["pos_s"][rows].contiguous(), L["mass_s"][rows].contiguous(),
                L["tgt"], L["ni"], L["nv"])
        before = bh_kernels.LAUNCHES["near_field_window"]
        acc, pot = bh_kernels.near_field(*args, leaf_lo=s * nl, **kw)
        assert bh_kernels.LAUNCHES["near_field_window"] == before + 1
        acc_p, pot_p = bh_kernels.near_field_plain(*args, leaf_lo=s * nl,
                                                   **kw)
        _close(acc, acc_p)
        _close(pot, pot_p)
        total = acc if total is None else total + acc
    full, _ = bh_kernels.near_field(L["pos_s"], L["mass_s"], L["tgt"],
                                    L["ni"], L["nv"], **kw)
    _close(total, full)
    if n_sh == 1:
        same_items = bh_kernels.near_work(L["nv"], L["ni"], (0, n_leaves))
        win, _ = bh_kernels.near_field(L["pos_s"], L["mass_s"], L["tgt"],
                                       L["ni"], L["nv"], leaf_lo=0,
                                       work=same_items, **kw)
        assert torch.equal(win, full)


@pytest.fixture(scope="module")
def ring_lists(cuda):
    """Rank 0 of an 8-rank ring at leaf 256: N = 262144 (1024 leaves, 128
    a rank) Plummer particles, sorted; rank 0's target leaves and near
    lists (theta 0.72, octet) with every third row emptied, and the window
    edges of the 8 shards. Window 0 (the rank's own) is heavy, the others
    light."""
    leaf, n_ranks, theta = 256, 8, 0.72
    cfg = SimConfig(n=262144, ic="plummer", seed=5)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve="hilbert",
        multipole_order=2)
    n_leaves = n_pad // leaf
    nl = n_leaves // n_ranks
    far, rej = bh.traverse(tree, theta, start_leaf=0, n_slice=nl)
    ni, nv, *_, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=theta, start_leaf=0, n_slice=nl,
        near_budget=n_leaves, far_budget=n_leaves, dtype=torch.float32)
    assert int(of) == 0
    nv[::3] = False
    out = dict(pos_s=pos_s, mass_s=mass_s,
               tgt=pos_s[:nl * leaf].reshape(nl, leaf, 3), ni=ni, nv=nv)
    out = {k: v.contiguous().to(cuda) for k, v in out.items()}
    out["edges"] = [w * nl for w in range(n_ranks + 1)]
    return out


def _ring_window(R, w, fn=bh_kernels.near_field, **kw):
    e = R["edges"]
    rows = slice(e[w] * 256, e[w + 1] * 256)
    return fn(R["pos_s"][rows].contiguous(), R["mass_s"][rows].contiguous(),
              R["tgt"], R["ni"], R["nv"], g=1.5, softening=0.02,
              leaf_lo=e[w], **kw)


def _window_counts(R, w):
    e, ni, nv = R["edges"], R["ni"], R["nv"]
    lo = torch.sum(nv & (ni < e[w]), dim=1)
    return torch.sum(nv & (ni < e[w + 1]), dim=1) - lo, lo


@pytest.mark.parametrize("mode", ["write", "add"])
@pytest.mark.parametrize("window", ["heavy", "light"])
@pytest.mark.parametrize("shape", bh_kernels.WINDOW_SHAPES,
                         ids=lambda s: f"r{s[0]}c{s[1]}")
def test_near_field_window_shapes_match_plain(ring_lists, shape, window,
                                              mode):
    """K1's window form at each launch shape it can choose (targets a
    thread x entries an item), on a heavy and a light window, writing its
    output or adding into one, against its plain version; a second launch
    from the same start gives the same bits; an added window leaves the
    rows without entries as they were."""
    R = ring_lists
    counts = [int(_window_counts(R, w)[0].sum())
              for w in range(len(R["edges"]) - 1)]
    w = 0 if window == "heavy" else min(
        (c, w) for w, c in enumerate(counts) if c > 0)[1]
    assert counts[0] > 4 * counts[w] or window == "heavy"
    c, lo = _window_counts(R, w)
    r, chunk = shape
    work = bh_kernels.near_items(c, chunk, lo=lo, r=r,
                                 every_row=mode == "write")
    n = R["tgt"].shape[0] * 256
    gen = torch.Generator(device="cpu").manual_seed(7)
    start = (torch.randn((n, 3), generator=gen).cuda(),
             torch.randn((n,), generator=gen).cuda())

    def run(fn=bh_kernels.near_field, **extra):
        out = None if mode == "write" else tuple(t.clone() for t in start)
        return _ring_window(R, w, fn, compute_pot=True, out=out, **extra)

    got = run(work=work)
    for a, b in zip(got, run(bh_kernels.near_field_plain)):
        _close(a, b)
    again = run(work=work)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if mode == "add":
        empty = (c == 0).repeat_interleave(256)
        assert bool(empty.any())
        assert torch.equal(got[0][empty], start[0][empty])
        assert torch.equal(got[1][empty], start[1][empty])


@pytest.mark.parametrize("compute_pot", [True, False])
def test_ring_window_form_accumulates_as_written_and_added(ring_lists,
                                                           compute_pot):
    """The ring's windows in pass order (0, 7, 6, ..., 1), the first
    written and the others added in place, equal the same launches each
    written and added by torch in that order, bit for bit, at every
    targets-a-thread (the sum order of a target does not depend on it);
    the windows shaped by their work (parallel/distributed.ring_windows)
    match the plain ring."""
    R = ring_lists
    n_win = len(R["edges"]) - 1
    order = [(0 - p) % n_win for p in range(n_win)]
    items = bh_kernels.near_windows(R["ni"], R["nv"], R["edges"], chunk=8)
    kw = dict(compute_pot=compute_pot)
    want = None
    for w in order:
        a = _ring_window(R, w, work=items[w], **kw)
        want = a if want is None else tuple(x + y for x, y in zip(want, a))
    for r in (1, 2, 4, 8):
        out = None
        for w in order:
            work = dataclasses.replace(items[w], r=r)
            out = _ring_window(R, w, work=work, out=out, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), r
    shaped = bh_kernels.near_windows(R["ni"], R["nv"], R["edges"],
                                     writes=(0,), leaf_size=256)
    assert shaped[0].every_row and not any(s.every_row for s in shaped[1:])
    out = plain = None
    for w in order:
        out = _ring_window(R, w, work=shaped[w], out=out, **kw)
        plain = _ring_window(R, w, bh_kernels.near_field_plain, out=plain,
                             **kw)
    _close(out[0], plain[0])
    _close(out[1], plain[1])
    with pytest.raises(ValueError, match="add into"):
        _ring_window(R, 1, work=shaped[1], **kw)


@pytest.mark.parametrize("cut", [1.0, 0.5])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_table_form_matches_plain(lists, cut, compute_pot):
    """K1's table form (src_table=) on the packed table of the sorted
    particles, whole and cut to its first rows (entries past the table
    skipped), against its plain version."""
    L = lists
    n_leaves = L["tgt"].shape[0]
    rows = int(n_leaves * cut) * LEAF
    table = torch.cat([L["pos_s"], L["mass_s"][:, None]], 1)[:rows]
    kw = dict(g=1.5, softening=0.02, compute_pot=compute_pot)
    args = (None, None, L["tgt"], L["ni"], L["nv"])
    before = bh_kernels.LAUNCHES["near_field_table"]
    acc, pot = bh_kernels.near_field(*args, src_table=table.contiguous(),
                                     **kw)
    assert bh_kernels.LAUNCHES["near_field_table"] == before + 1
    acc_p, pot_p = bh_kernels.near_field_plain(*args, src_table=table, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    if cut == 1.0:
        full = bh_kernels.near_field(L["pos_s"], L["mass_s"], L["tgt"],
                                     L["ni"], L["nv"], **kw)
        assert all(torch.equal(a, b) for a, b in zip((acc, pot), full))


@pytest.mark.parametrize("comm", ["ring", "let"])
def test_two_gloo_ranks_on_one_card(cuda, comm):
    """dist_bh_accel on two ranks that share the card (gloo, tensors staged
    through host memory): the K1 form of the near field and K2 launched on
    every rank, overflow 0, forces in the single-device Barnes-Hut's class
    against the direct sum."""
    from parallelnbody_tpu_torch.ops import bh
    from parallelnbody_tpu_torch.parallel import launch, mesh, tasks
    from parallelnbody_tpu_torch.state import state_to_numpy

    cfg = SimConfig(n=16384, ic="plummer", seed=3, force="barnes_hut",
                    bh_leaf_size=64, bh_near_budget=256, bh_far_budget=512,
                    bh_distributed=True, bh_comm=comm, mesh_shape=(2,))
    state = init_simulation(cfg, "cpu", compute_forces=False)
    outs = launch(tasks.sharded, 2, cfg.to_json(), state_to_numpy(state),
                  "dist_accel", device="cuda", timeout=300)
    form = "near_field_window" if comm == "ring" else "near_field_table"
    for st in mesh.LAST_RANK_STATS:
        assert st["backend"] == "gloo" and st["staged_bytes"] > 0
        assert st["launches"][form] == (2 if comm == "ring" else 1)
        assert st["launches"]["far_octet"] == 1
    assert outs[0]["overflow"] == 0
    acc = torch.from_numpy(np.concatenate([o["state"]["acc"] for o in outs]))
    single, _, of = bh.bh_accel(
        state.pos.to(cuda), state.mass.to(cuda), leaf_size=64, theta=0.5,
        softening=0.01, near_budget=256, far0_budget=512, multipole=2)
    assert int(of) == 0
    kw = dict(g=1.0, softening=cfg.softening, k=1024)
    rms = rms_force_error_sample(state.pos, state.mass, acc, **kw)
    rms_single = rms_force_error_sample(state.pos, state.mass, single.cpu(),
                                        **kw)
    assert rms < 1.5 * rms_single + 1e-3, (rms, rms_single)


# ------------------------------------------------ K5-K7 (tensor cores)

MMA_N = 8192


@pytest.fixture(scope="module")
def mma_inputs(cuda):
    """Hilbert-sorted Plummer (the tool's inputs) at N = 8192 on the card."""
    from parallelnbody_tpu_torch.tools import mxu_allpairs

    return mxu_allpairs.plummer_sorted(MMA_N, cuda)


def _mma(variant, pos, mass, precision, **kw):
    from parallelnbody_tpu_torch.ops import direct_mma

    args = dict(softening=0.01, precision=precision, **kw)
    return (direct_mma.WRAPPERS[variant](pos, mass, **args),
            direct_mma.PLAIN[variant](pos, mass, **args))


@pytest.mark.parametrize("precision", [1, 3])
@pytest.mark.parametrize("variant", ["v3", "v1", "v4"])
def test_mma_kernel_matches_plain(mma_inputs, variant, precision):
    """K5-K7 against their plain versions on the raw sums: the same TF32
    operands and products; V1's cross term summed as the tensor core sums
    it (direct_mma.tensor_core_step), the sums over sources in f32."""
    from parallelnbody_tpu_torch.ops import direct_mma

    direct_mma.reset_launch_counts()
    got, want = _mma(variant, *mma_inputs, precision)
    assert direct_mma.LAUNCHES[f"allpairs_mma_{variant}"] == 1
    _close(got, want)


@pytest.mark.parametrize("precision", [1, 3])
@pytest.mark.parametrize("variant", ["v3", "v1"])
@pytest.mark.parametrize("n", [1000, 4133])
def test_mma_kernel_partial_tiles(cuda, variant, precision, n):
    """V3 and V1 at an n that fills neither the last block of targets nor
    the last slab of 8 sources: massless zero sources add exactly 0."""
    g = np.random.default_rng(n)
    pos = torch.from_numpy(g.standard_normal((n, 3)).astype(np.float32))
    mass = torch.from_numpy(g.uniform(0.5, 1.5, n).astype(np.float32) / n)
    got, want = _mma(variant, pos.to(cuda), mass.to(cuda), precision)
    _close(got, want)


@pytest.mark.parametrize("tiles", [(128, 512, 0), (64, 64, 2), (256, 1024, 3)],
                         ids=["512-band0", "64-band2", "1024-band3"])
@pytest.mark.parametrize("precision", [1, 3])
def test_mma_v4_tiles_and_bands(mma_inputs, tiles, precision):
    """V4 at other function tiles: j-tiles that end inside the kernel's
    staged tile (64), several per staged tile, and wider bands."""
    tile_i, tile_j, band_tiles = tiles
    got, want = _mma("v4", *mma_inputs, precision, tile_i=tile_i,
                     tile_j=tile_j, band_tiles=band_tiles)
    _close(got, want)


@pytest.mark.parametrize("precision", [1, 3])
@pytest.mark.parametrize("variant", ["v3", "v1", "v4"])
def test_mma_kernel_repeat_bit_equal(mma_inputs, variant, precision):
    """No float atomics: the source ranges' partial sums are added in
    order, so two launches on the same inputs give the same bits."""
    from parallelnbody_tpu_torch.ops import direct_mma

    fn = direct_mma.WRAPPERS[variant]
    first = fn(*mma_inputs, softening=0.01, precision=precision)
    second = fn(*mma_inputs, softening=0.01, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_mma_wrappers_refuse_on_the_card(mma_inputs):
    from parallelnbody_tpu_torch.ops import direct_mma

    pos, mass = mma_inputs
    for fn in direct_mma.WRAPPERS.values():
        with pytest.raises(TypeError, match="float32 only"):
            fn(pos.double(), mass.double(), softening=0.01, precision=3)
    with pytest.raises(ValueError, match="multiple of tile_j"):
        direct_mma.allpairs_mma_v4(pos[:3000].contiguous(),
                                   mass[:3000].contiguous(), softening=0.01,
                                   precision=3)
    with pytest.raises(ValueError, match="multiple of tile_j"):
        direct_mma.allpairs_mma_v4(pos, mass, softening=0.01, precision=1,
                                   tile_i=96, tile_j=512)


def test_mma_tool_table_on_the_card(cuda):
    """tools/mxu_allpairs.py at a small size: a record for each variant,
    V4 at 3xTF32 and V0 (K3) below the all-pairs rms bound 1e-4."""
    from parallelnbody_tpu_torch.tools import mxu_allpairs

    recs = mxu_allpairs.table(4096, 8192, iters=2)
    assert [r["variant"] for r in recs] == [v[0] for v in
                                            mxu_allpairs.VARIANTS]
    by = {(r["kernel"], r["precision"]): r for r in recs}
    assert by[("v4", 3)]["rms_err"] < 1e-4
    assert by[("v0", None)]["rms_err"] < 1e-4
    assert all(r["ms"] > 0 and r["share"] > 0 for r in recs)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("spread", ["positions", "exponents"])
def test_tensor_core_step_is_the_cards_mma(cuda, k, spread):
    """direct_mma.tensor_core_step, the model of one TF32 mma.sync that
    V1's plain version sums its cross term with, gives the card's bits:
    2000 problems of TF32 operands (position-like, or with exponents over
    2^-8..2^8 and either sign) and f32 accumulators (zero or random)."""
    import ctypes

    from parallelnbody_tpu_torch.kernels import build
    from parallelnbody_tpu_torch.ops import direct_mma

    g = np.random.default_rng(k)
    n = 2000

    def draw(shape):
        if spread == "positions":
            return g.standard_normal(shape) * 0.7
        return (g.choice([-1.0, 1.0], shape) * g.uniform(1, 2, shape)
                * 2.0 ** g.integers(-8, 8, shape))

    a = direct_mma.tf32_round(torch.tensor(draw((n, 16, k)),
                                           dtype=torch.float32))
    b = direct_mma.tf32_round(torch.tensor(draw((n, k, 8)),
                                           dtype=torch.float32))
    c = torch.tensor(draw((n, 16, 8)), dtype=torch.float32)
    c[: n // 2] = 0.0
    dev = [t.to(cuda).contiguous() for t in (a, b, c)]
    d = torch.empty_like(dev[2])
    lib = build.load_library()
    err = lib.pnb_mma_tf32_probe(
        *(ctypes.c_void_p(t.data_ptr()) for t in (*dev, d)), n, k,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    got = d.cpu()
    want = torch.stack([direct_mma.tensor_core_step(a[p], b[p].T, c[p])
                        for p in range(n)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --------------------------------------- K8-K11 (near-field experiments)
@pytest.fixture(scope="module")
def probe_inputs(cuda):
    """K1's lists at N = 65536, leaf 256, theta 0.72 (the probe tool's,
    built on the card), and their flat form at each step size."""
    from parallelnbody_tpu_torch.ops import near_flat
    from parallelnbody_tpu_torch.tools import near_kernel_probe as probe

    L = probe.probe_lists(65536, cuda)
    L["flat"] = {p: near_flat.pack_lists(L["table"].transpose(1, 2),
                                         L["idx"], L["valid"], p)[:2]
                 for p in near_flat.STEP_PACKS}
    return L


def _probe_args(L):
    return L["tgt_t"], L["table"], L["idx"], L["valid"]


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("n_comp", [4, 8])
@pytest.mark.parametrize("unroll", [4, 8])
@pytest.mark.parametrize("mode", ["A", "B", "C", "E"])
def test_near_probe_kernel_matches_plain(probe_inputs, mode, unroll, n_comp,
                                         segments):
    from parallelnbody_tpu_torch.ops import near_probe

    n_leaves = probe_inputs["tgt_t"].shape[0]
    kw = dict(mode=mode, unroll=unroll, n_comp=n_comp,
              rows_per_seg=n_leaves // segments)
    args = _probe_args(probe_inputs)
    got = near_probe.near_probe(*args, **kw)
    _close(got, near_probe.near_probe_plain(*args, **kw))
    assert torch.equal(got, near_probe.near_probe(*args, **kw))


def test_near_probe_mode_a_equals_k1(probe_inputs):
    """Mode A over 4 segments, the segment base subtracted, sums K1's
    pairs: its acceleration equals K1's kernel (g = 1, no potential)."""
    from parallelnbody_tpu_torch.ops import near_probe

    L = probe_inputs
    n_leaves, g, _ = L["tgt"].shape
    acc, _ = bh_kernels.near_field(L["pos_s"], L["mass_s"], L["tgt"],
                                   L["idx"], L["valid"], g=1.0,
                                   softening=0.01, compute_pot=False)
    got = near_probe.near_probe(*_probe_args(L), mode="A", unroll=4,
                                rows_per_seg=n_leaves // 4)
    _close(got[:, :3], acc.reshape(n_leaves, g, 3).transpose(1, 2))
    assert not got[:, 3].any()


@pytest.fixture(scope="module")
def long_row_inputs(probe_inputs):
    """The N = 65536 lists with row 0's list made every leaf (256 entries:
    8 items of NEAR_CHUNK, 2 in each of 4 segments), and its flat form at
    each step size (row 0: 128 / 64 / 32 steps, 8 items each)."""
    from parallelnbody_tpu_torch.ops import near_flat

    L = dict(probe_inputs)
    n_leaves = L["tgt_t"].shape[0]
    idx, valid = L["idx"].clone(), L["valid"].clone()
    if idx.shape[1] < n_leaves:
        pad = n_leaves - idx.shape[1]
        idx = torch.cat([idx, idx.new_full((n_leaves, pad), 2**31 - 1)], 1)
        valid = torch.cat([valid, valid.new_zeros((n_leaves, pad))], 1)
    idx[0] = torch.arange(n_leaves, dtype=idx.dtype, device=idx.device)
    valid[0] = True
    L["idx"], L["valid"] = idx.contiguous(), valid
    L["flat"] = {p: near_flat.pack_lists(L["table"].transpose(1, 2), idx,
                                         valid, p)[:2]
                 for p in near_flat.STEP_PACKS}
    return L


@pytest.mark.parametrize("chunk", [32, 5])
@pytest.mark.parametrize("mode", ["A", "B", "C", "E"])
def test_near_probe_row_split_into_many_items(long_row_inputs, mode, chunk):
    """A row of every leaf in 4 segments, cut into items of 32 entries (2
    a segment) and of 5 (13 a segment, none aligned with the segment
    edges of the row's run): the kernel against its plain version, and
    launched twice the same bits."""
    from parallelnbody_tpu_torch.ops import near_probe

    L = long_row_inputs
    rows = L["tgt_t"].shape[0] // 4
    bnd = near_probe.probe_bounds(L["idx"], L["valid"], rows)
    items = near_probe.probe_items(bnd, chunk)
    assert int(items[1].items[:, 0].eq(0).sum()) == -(-rows // chunk)
    kw = dict(mode=mode, unroll=4, rows_per_seg=rows)
    args = _probe_args(L)
    got = near_probe.near_probe(*args, **kw, bnd=bnd, items=items)
    _close(got, near_probe.near_probe_plain(*args, **kw))
    assert torch.equal(got, near_probe.near_probe(*args, **kw, bnd=bnd,
                                                  items=items))


@pytest.mark.parametrize("mode", ["step", "row"])
@pytest.mark.parametrize("packs", [4, 8, 16])
def test_flat_tune2_row_split_into_many_items(long_row_inputs, packs, mode):
    """K11 on the flat form with row 0 of every leaf (8 items at the
    wrapper's chunk), and on items of 3 steps: against its plain version
    and, launched twice, the same bits."""
    from parallelnbody_tpu_torch.ops import near_flat

    L = long_row_inputs
    n_rows = L["tgt_t"].shape[0]
    rows, src = L["flat"][packs]
    kw = dict(step_packs=packs, mode=mode, eps2=1e-4)
    args = (rows, L["tgt_t"], src)
    want = near_flat.flat_tune2_plain(*args, **kw)
    starts = near_flat.row_starts(rows, n_rows)
    for work in (near_flat.lane_items(rows, n_rows, packs),
                 bh_kernels.near_items(starts[1:] - starts[:-1], 3,
                                       lo=starts[:-1])):
        assert int(work.items[:, 0].eq(0).sum()) >= 8
        got = near_flat.flat_tune2(*args, **kw, work=work)
        _close(got, want)
        assert torch.equal(got, near_flat.flat_tune2(*args, **kw, work=work))


def _flat_call(kernel, L, packs, variant, compute_pot, eps2=1e-4):
    from parallelnbody_tpu_torch.ops import near_flat

    rows, src = L["flat"][packs]
    fn = {"K9": near_flat.flat_near, "K10": near_flat.flat_tune,
          "K11": near_flat.flat_tune2}[kernel]
    plain = {"K9": near_flat.flat_near_plain,
             "K10": near_flat.flat_tune_plain,
             "K11": near_flat.flat_tune2_plain}[kernel]
    kw = dict(eps2=eps2, compute_pot=compute_pot)
    if kernel == "K10":
        kw.update(step_packs=packs, out_mode=variant)
    elif kernel == "K11":
        kw.update(step_packs=packs, mode=variant)
    args = (rows, L["tgt_t"], src)
    return (lambda: fn(*args, **kw)), (lambda: plain(*args, **kw))


@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("kernel,packs,variant",
                         [("K9", 4, None)]
                         + [("K10", p, m) for p in (4, 8, 16)
                            for m in ("rmw", "steps")]
                         + [("K11", p, m) for p in (4, 8, 16)
                            for m in ("step", "row")])
def test_flat_kernels_match_plain_on_k1s_lists(probe_inputs, kernel, packs,
                                               variant, compute_pot):
    """Each flat kernel on the flat form of K1's N = 65536 lists against
    its plain version; launched twice, the same bits."""
    call, plain = _flat_call(kernel, probe_inputs, packs, variant,
                             compute_pot)
    got = call()
    _close(got, plain())
    assert torch.equal(got, call())
    if not compute_pot:
        assert not got[:, 3].any()


@pytest.mark.parametrize("kernel,packs,variant",
                         [("K9", 4, None), ("K10", 4, "steps"),
                          ("K11", 16, "row")])
def test_flat_kernels_equal_k1(probe_inputs, kernel, packs, variant):
    """The flat form holds K1's pairs plus zero-mass padding: each kernel's
    sums equal K1's (acceleration, and the potential sum negated)."""
    L = probe_inputs
    n_leaves, g, _ = L["tgt"].shape
    acc, pot = bh_kernels.near_field(L["pos_s"], L["mass_s"], L["tgt"],
                                     L["idx"], L["valid"], g=1.0,
                                     softening=0.01, compute_pot=True)
    want = torch.cat([acc.reshape(n_leaves, g, 3),
                      -pot.reshape(n_leaves, g, 1)], dim=2).transpose(1, 2)
    call, _ = _flat_call(kernel, L, packs, variant, True)
    _close(call(), want)


def test_flat_out_modes_agree_bit_for_bit(probe_inputs):
    """K10 "steps" adds each row's step partials in step order, the sum
    "rmw" carries: the same bits."""
    rmw, _ = _flat_call("K10", probe_inputs, 8, "rmw", True)
    steps, _ = _flat_call("K10", probe_inputs, 8, "steps", True)
    assert torch.equal(rmw(), steps())


@pytest.mark.parametrize("packs", [4, 8, 16])
def test_flat_kernels_on_the_scripts_correctness_sizes(cuda, packs):
    """The shapes of the scripts' own checks (flat_kernel_tune2.py: 64
    rows, poisson(6) sub-tiles a row, G = 256; masses made positive, as
    flat_kernel_proto.py's check makes them): K10 and K11 against their
    plain versions within rtol 2e-4 of each row's largest |value| plus
    atol 2e-5 (random sources cancel some sums to near zero, where two
    f32 orders of 2048 terms of up to ~100 differ by ~1e-4), K11's two
    modes within the script's 1e-3 of each other."""
    from parallelnbody_tpu_torch.ops import near_flat
    from parallelnbody_tpu_torch.tools import flat_kernel

    args = dict(flat_kernel.tune2_check_inputs(np.random.default_rng(0),
                                               cuda))[packs]
    args[2][:, :, 3].abs_()
    outs = {}
    for fn, plain, key, modes in (
            (near_flat.flat_tune, near_flat.flat_tune_plain, "out_mode",
             near_flat.OUT_MODES),
            (near_flat.flat_tune2, near_flat.flat_tune2_plain, "mode",
             near_flat.LANE_MODES)):
        for m in modes:
            kw = {"step_packs": packs, key: m}
            outs[m] = got = fn(*args, **kw)
            want = plain(*args, **kw)
            scale = want.abs().amax(dim=(1, 2), keepdim=True)
            assert bool(((got - want).abs() <= ATOL + RTOL * scale).all())
    assert float((outs["step"] - outs["row"]).abs().max()) < 1e-3


def test_flat_wrappers_refuse_on_the_card(probe_inputs):
    from parallelnbody_tpu_torch.ops import near_flat

    rows, src = probe_inputs["flat"][4]
    bad = rows.clone()
    bad[bad == 3] = 2                           # row 3 owns no step
    with pytest.raises(ValueError, match="ascend"):
        near_flat.flat_near(bad, probe_inputs["tgt_t"], src, eps2=1e-4)
    with pytest.raises(ValueError, match="multiple of 32"):
        near_flat.flat_tune2(rows, probe_inputs["tgt_t"][:, :, :48].
                             contiguous(), src, step_packs=4, mode="row")


# ------------------------------------------------ per-phase geometry tools
@pytest.mark.parametrize("refine,far_mode", [("dense", "gather"),
                                             ("dense", "octet"),
                                             ("staged", "octet"),
                                             ("staged", "gather")])
def test_bh_breakdown_on_the_card(cuda, refine, far_mode):
    """tools/bh_breakdown.py at N = 65536, leaf 64: every phase timed on
    the card (events and busy ms), the composed phases equal to bh_accel
    (the tool raises beyond rtol 2e-4 / atol 2e-5), nothing clipped."""
    from parallelnbody_tpu_torch.tools import bh_breakdown

    bh_kernels.reset_launch_counts()
    recs = bh_breakdown.main(["--n", "65536", "--leaf", "64", "--near",
                              "1024", "--far", "1024", "--iters", "2",
                              "--refine", refine, "--far-mode", far_mode])
    summary = recs[-1]
    assert summary["overflow"] == 0
    assert summary["max_abs_diff"] < 1e-3
    assert all(r["ms"] > 0 and r["busy_ms"] > 0 for r in recs[:-1])
    assert summary["per_step_ms"] > 0 and summary["peak_gib"] > 0
    assert bh_kernels.LAUNCHES["near_field"] > 0
    far = "far_octet" if far_mode == "octet" else "far_gather"
    assert bh_kernels.LAUNCHES[far] > 0
    assert ("rebuild_ms" in summary) == (far_mode == "octet")


def test_geometry_tools_on_the_card(cuda):
    """tools/li_profile.py, staged_probe.py (phases), octet_probe.py
    (--quick), reuse_probe.py and theta_sweep.py at small N on the card:
    each timed line has its events and busy ms, li_profile's stages
    compose to leaf_interactions' lists, reuse_probe's runs clip
    nothing."""
    from parallelnbody_tpu_torch.tools import (li_profile, octet_probe,
                                               reuse_probe, staged_probe,
                                               theta_sweep)

    it = ["--iters", "2"]
    li = li_profile.main(["--n", "65536", "--leaf", "64"] + it)
    assert li[-1]["lists_equal"] and li[-1]["l1_overflow"] == 0
    sp = staged_probe.main(["--n", "65536", "--leaf", "64", "--near", "1024",
                            "--far", "1024", "--mode", "phases"] + it)
    assert [r["phase"] for r in sp][-2:] == [
        "K1 near (items prebuilt)", "K1 near (items built in the call)"]
    op = octet_probe.main(["--n", "65536", "--quick"])
    assert [r["far_kernel"] for r in op] == ["K4", "K2"]
    assert op[0]["far_terms"] == op[1]["far_terms"] > 0
    rp = reuse_probe.main(["--n", "65536", "--k", "2"] + it)
    assert [r["step"] for r in rp if "step" in r] == [1, 2]
    ts = theta_sweep.main(["--n", "65536", "--n-rms", "16384"] + it)
    assert [r["theta"] for r in ts] == [0.7, 0.75, 0.8, 0.85]
    for r in li[:-1] + sp + op + rp[:3] + ts:
        assert r["ms"] > 0 and r["busy_ms"] > 0, r


def test_busy_reading_holds_the_launches(lists):
    """measure.busy_reading on one K2 launch is whole, with device time;
    with a K1 launch counted and no K1 record (as a session that lost it
    would read) it is not."""
    from parallelnbody_tpu_torch.tools import measure

    L = lists
    order = bh_kernels.far_order(L["fv"])

    def k2():
        return bh_kernels.far_octet(L["tgt"], L["nodes8"], L["fk"], L["fv"],
                                    order=order, g=1.0, softening=0.01)

    k2()
    busy, whole = measure.busy_reading(k2)
    assert whole and busy > 0

    def k2_and_a_lost_k1():
        bh_kernels.LAUNCHES["near_field"] += 1
        return k2()

    assert not measure.busy_reading(k2_and_a_lost_k1)[1]


def test_bench_suite_row_on_the_card(cuda):
    """tools/bench_suite.py's step and rebuild rows at N = 65536 on the
    card: events and busy time, calibrated budgets that do not clip, K1
    and K2 launched in the timed steps, the rms class."""
    from parallelnbody_tpu_torch.tools import bench_suite

    cfg = SimConfig(n=65536, force="barnes_hut", theta=0.72,
                    track_potential=False, **bench_suite.COMMON)
    for row in (bench_suite.measure_step(cfg, cuda, iters=2),
                bench_suite.measure_reuse(cfg, cuda, k=4, n_steps=8)):
        assert row["overflow"] == 0 and row["rms_force_error"] < 2e-3
        assert row["launches"]["near_field"] > 0
        assert row["launches"]["far_octet"] > 0
        assert row["events_ms_per_step"] > 0 and row["peak_gib"] > 0
        assert row["leaf"] == 128 and row["refine"] == "dense"
    direct = bench_suite.measure_step(
        SimConfig(n=16384, force="direct_pallas", track_potential=False,
                  **bench_suite.COMMON), cuda, iters=2)
    assert direct["launches"]["allpairs"] > 0 and direct["pairs_per_sec"] > 0


def test_sections_probe_on_the_card(cuda):
    """tools/sections_probe.py at N = 262144, leaf 64, in 1, 2 and 4
    windows: forces bit-equal among the sectioned counts (one-way K1) and
    within the kernels' tolerance of one window's (mutual K1; the tool
    raises otherwise), timed."""
    from parallelnbody_tpu_torch.tools import sections_probe

    rows = sections_probe.main(["--n", "262144", "--leaf", "64",
                                "--sections", "1", "2", "4", "--iters",
                                "2"])
    assert [(r["resolved"], r["bit_equal_to"], r.get("close_to"))
            for r in rows] == [(1, 1, None), (2, 2, 1), (4, 2, 1)]
    assert all(r["ms"] > 0 and r["peak_gib"] > 0 for r in rows)


def test_collectives_and_distributed_probes_on_the_card(cuda):
    """Two ranks sharing the card (gloo, host staging): the collective
    counts recompose into the structure of each run
    (dist_collectives_probe.structure raises otherwise), K1's window and
    table forms and K2 launch on the ranks, the production probe's runs
    clip nothing and stay in the rms class, and the exchange volume probe
    counts its migrants."""
    from parallelnbody_tpu_torch.parallel import RankPool
    from parallelnbody_tpu_torch.tools import (dist_collectives_probe,
                                               dist_production_probe,
                                               exchange_volume_probe)

    with RankPool(2, cuda, timeout=300.0) as pool:
        recs = dist_collectives_probe.probe(pool, 4096, 4, 2,
                                            ["ring", "let"], cuda)
        for r in recs[:-1]:
            assert r["overflow"] == 0
            form = ("near_field_window" if r["comm"] == "ring"
                    else "near_field_table")
            assert r["launches_rank0"][form] > 0
            assert r["launches_rank0"]["far_octet"] > 0
        rep = dist_production_probe.probe(
            pool, dist_production_probe.make_cfg(16384, 64, 512, 1024, 2),
            4, cuda)
        for comm in ("ring", "let"):
            assert rep[comm]["overflow"] == 0
            assert rep[comm]["rms_force_error"] < 2e-3
        assert rep["ring_vs_let_max_pos_diff"] < 1e-4
        name, cfg = exchange_volume_probe.cases(8192, 0.004, 0.9, 1.0,
                                                4.0)[0]
        rec = exchange_volume_probe.run_case(pool, name, cfg, 4, cuda)
        assert rec["overflow"] == 0 and len(rec["migrants"]) == 4
        assert rec["collectives_rank0"]["all_to_all"] > 0


def test_let_probes_on_the_card(cuda):
    """tools/let_halo_probe.py and let_granularity_probe.py at N = 65536
    on the card: counts in range, no clip, the card's leaf rule."""
    from parallelnbody_tpu_torch.tools import (let_granularity_probe,
                                               let_halo_probe)

    for rec in let_halo_probe.main(["--n", "65536", "--ranks", "4"]):
        assert rec["leaf"] == 128 and rec["overflow"] == 0
        assert 0 < rec["max_import_frac"] <= 0.75
    for row in let_granularity_probe.main(["--n", "65536", "--ranks", "4"]):
        assert row["leaf"] == 128
        s1 = row["variants"]["s1_leaf"]["rows_per_rank_mean"]
        s8 = row["variants"]["s8_subtile"]["rows_per_rank_mean"]
        assert 0 < s8 <= s1


@pytest.fixture
def cpu_tree(monkeypatch):
    """bh._prepare on a CUDA input builds the pyramid on the CPU and moves
    it to the card, so that a tool's lists on the card are those of its
    CPU run (the tree's sums round otherwise in another order)."""
    prepare = bh._prepare

    def same_tree(pos, mass, **kw):
        if pos.device.type != "cuda":
            return prepare(pos, mass, **kw)
        out = prepare(pos.cpu(), mass.cpu(), **kw)
        move = lambda t: None if t is None else t.to(pos.device)  # noqa
        tree = bh.BHTree(*(tuple(move(x) for x in field)
                           for field in out[3]))
        return (*(move(t) for t in out[:3]), tree, *out[4:])
    monkeypatch.setattr(bh, "_prepare", same_tree)


def _stat_args(tool, *argv):
    return tool.parser().parse_args([*argv, "--iters", "2"])


def _plummer(n, dev):
    state = init_simulation(SimConfig(n=n, ic="plummer", softening=0.01),
                            "cpu", compute_forces=False)
    return state.pos.to(dev), state.mass.to(dev)


def test_near_octet_and_refine_stats_on_the_card(cuda, cpu_tree):
    """tools/near_octet_stats.py and near_refine_probe.py at N = 16384,
    leaf 64 on the card and on the CPU from one pyramid: the same
    statistics, and on the card K1's rate with its launch held to the
    plain version."""
    from parallelnbody_tpu_torch.tools import (near_octet_stats,
                                               near_refine_probe)

    args = _stat_args(near_octet_stats, "--leaf", "64", "--near", "256",
                      "--far", "256")
    got, want = (near_octet_stats.stats(*_plummer(16384, dev), args)[-1]
                 for dev in (cuda, torch.device("cpu")))
    assert {k: got[k] for k in ("near_count", "octets_per_target",
                                "mask_fill", "overflow")} == {
        k: want[k] for k in ("near_count", "octets_per_target", "mask_fill",
                             "overflow")}
    args = _stat_args(near_refine_probe, "--leaf", "64", "--chunk", "128")
    got, want = (near_refine_probe.probe(*_plummer(16384, dev), args)
                 for dev in (cuda, torch.device("cpu")))
    assert got[0]["k1_pairs_per_s"] > 0 and got[0]["k1_max_abs_err"] < 1e-3
    for g, w in zip(got[1:], want[1:]):
        assert g["near_leaf_entries"] == w["near_leaf_entries"]
        assert g["refined_subs"] == pytest.approx(w["refined_subs"],
                                                  rel=1e-3)
        assert g["ms_eq_cur"] > 0 and g["ms"] > 0


def test_cell_leaves_probe_on_the_card(cuda):
    """tools/cell_leaves_probe.py at N = 16384, G = 64: the card's tiles
    and true pairs within 1e-3 of the CPU's (the leaf CoMs' sums round in
    another order), K1's and K11's rates measured and held."""
    from parallelnbody_tpu_torch.tools import cell_leaves_probe

    args = _stat_args(cell_leaves_probe, "--g", "64")
    got, want = (cell_leaves_probe.probe(*_plummer(16384, dev), args)
                 for dev in (cuda, torch.device("cpu")))
    assert got[0]["k1_pairs_per_s"] > 0 and got[0]["k11_pairs_per_s"] > 0
    for g, w in zip(got[1:], want[1:]):
        assert g["structure"] == w["structure"]
        assert g["tiles"] == pytest.approx(w["tiles"], rel=1e-3)
        assert g["true_pairs"] == pytest.approx(w["true_pairs"], rel=1e-3)
        assert g["padded_ms"] > 0 and g["true_ms"] > 0


def test_mac_and_aniso_probes_on_the_card(cuda, cpu_tree):
    """tools/mac_experiment.py's run and aniso_bounds_probe.py at
    N = 16384, leaf 64 on the card and on the CPU from one pyramid: the
    same overflow and masks, rms within 2e-5, each launch (K1, K4, K3)
    held to its plain version."""
    from parallelnbody_tpu_torch.tools import (aniso_bounds_probe,
                                               mac_experiment)

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        pos, mass = _plummer(16384, dev)
        ref, _ = direct_kernels.allpairs_accel_tile(
            pos, pos, mass, g=1.0, softening=0.01, compute_pot=False)
        runs[dev.type] = mac_experiment.run(pos, mass, "geom", 0.0, leaf=64,
                                            near=256, far=256,
                                            ref=ref.to(dev))
    assert runs["cuda"]["ovf"] == runs["cpu"]["ovf"] == 0
    assert abs(runs["cuda"]["rms"] - runs["cpu"]["rms"]) < 2e-5
    assert runs["cuda"]["max_abs_err_plain"] < 1e-3
    args = _stat_args(aniso_bounds_probe, "--leaf", "64", "--stride", "16",
                      "--thetas", "0.72")
    got, want = (aniso_bounds_probe.probe(*_plummer(16384, dev), args)
                 for dev in (cuda, torch.device("cpu")))
    for g, w in zip(got, want):
        assert (g["near_tiles"], g["far_leaf_entries"]) == (
            w["near_tiles"], w["far_leaf_entries"])
        assert abs(g["rms"] - w["rms"]) < 2e-5
        assert sorted(g["max_abs_err_plain"]) == ["allpairs", "far_gather",
                                                  "near_field"]


# ------------------------------------------------------------------ tracing
# The span each hand kernel's wrapper opens, by source file.
_WRAPPER_SPAN = {"allpairs.cu": "k3", "near_field.cu": "bh.near",
                 "far_octet.cu": "bh.far", "far_gather.cu": "bh.far"}


def _kernel_spans():
    """{__global__ kernel name: the span its wrapper opens}."""
    import re
    from pathlib import Path

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    csrc = Path(direct_kernels.__file__).resolve().parent.parent / "csrc"
    return {name: span for src, span in _WRAPPER_SPAN.items()
            for name in pat.findall((csrc / src).read_text())}


def _traced_call(call, state, path):
    """(call(state)'s output, the counters' growth, the Chrome trace's
    events) of one call under torch.profiler (CPU and CUDA) with the
    program's tracing on."""
    from torch.profiler import ProfilerActivity, profile

    from parallelnbody_tpu_torch.kernels import launch
    from parallelnbody_tpu_torch.utils import profiling

    before = launch.read_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, profiling.tracing(True):
        out = call(state)
        torch.cuda.synchronize()
    after = launch.read_counters()
    profiling.take_spans()
    prof.export_chrome_trace(str(path))
    import json

    events = json.loads(path.read_text())["traceEvents"]
    return out, {k: after[k] - before[k] for k in after}, events


def _launches_in_spans(events):
    """Every hand-kernel launch and device-to-host copy whose runtime call
    lies inside an `api.step` / `api.run` span: {span it must lie in:
    count}, asserting that it lies in that span (on the host's clock of
    the profiler, which the device records share)."""
    import collections
    import re

    ranges = collections.defaultdict(list)
    calls = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls[e.get("args", {}).get("correlation")] = e

    def inside(call, name):
        t0, t1 = call["ts"], call["ts"] + call.get("dur", 0)
        return any(s <= t0 and t1 <= t for s, t in ranges[name])

    kernels = _kernel_spans()
    found = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            want = [span for name, span in kernels.items()
                    if re.search(rf"\b{name}\b", e["name"])]
            if not want:
                continue
            want = want[0]
        elif e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]:
            want = "host_read"
        else:
            continue
        call = calls[e["args"]["correlation"]]
        if not (inside(call, "api.step") or inside(call, "api.run")):
            continue
        assert inside(call, want), (e["name"], call["name"], want)
        found[want] += 1
    return found


@pytest.mark.parametrize("case", ["direct", "bh_step", "bh_run2"])
def test_spans_hold_their_launches_and_host_reads(cuda, tmp_path, case):
    """One direct step and one Barnes-Hut step at N = 262144 (and a
    rebuild-2 run of 2 steps): every hand-kernel launch and every
    device-to-host copy made inside the call lies inside the span that
    made it (k3, bh.near, bh.far, host_read); k3.pairs is N^2, k1's pair
    terms are the near lists' entries x G^2 and the far terms the far
    lists' accepted children x G, counted from the plan's masks; host
    reads: none a direct step, one a Barnes-Hut list build."""
    from parallelnbody_tpu_torch import api

    n = 262144
    if case == "direct":
        cfg = SimConfig(n=n, force="direct_pallas", seed=5)
    else:
        cfg = SimConfig(n=n, force="barnes_hut", seed=5, theta=0.72,
                        bh_multipole=2, bh_rebuild_every=2)
    cfg, state = api.prepare_simulation(cfg, cuda)
    call = (api.make_run(cfg, 2, report_overflow=True) if case == "bh_run2"
            else api.make_step(cfg, report_overflow=True))
    state, _ = call(state)                    # warm-up
    torch.cuda.synchronize()
    (out, overflow), grew, events = _traced_call(call, state,
                                                 tmp_path / "trace.json")
    assert int(overflow) == 0
    found = _launches_in_spans(events)
    if case == "direct":
        assert grew["k3.pairs"] == n * n
        assert grew["host_reads"] == 0
        assert found["k3"] >= 1 and found["host_read"] == 0
        return
    # The lists the evaluations ran on: at the output's positions for a
    # step, at the input's for the run's one block.
    at = out if case == "bh_step" else state
    leaf = cfg.resolve_bh_leaf_size()
    _, _, _, tree, _, _ = bh._prepare(
        at.pos, at.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    refine, cands = bh.resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        tree.n_levels, cfg.resolve_bh_near_budget(),
        cfg.resolve_bh_far_budget())
    plan = bh.bh_plan_lists(
        tree, theta=cfg.theta, near_budget=cfg.resolve_bh_near_budget(),
        far_budget=cfg.resolve_bh_far_budget(), refine=refine,
        cand_budgets=cands, dtype=at.pos.dtype, leaf_size=leaf)
    evals = 1 if case == "bh_step" else 2
    entries = int(plan.near_valid.sum())
    assert grew["k1.pair_terms"] == evals * entries * leaf * leaf
    sym = bh_kernels.near_pairs(plan.near_idx, plan.near_valid).sym_entries
    assert grew["k1.sym_terms"] == evals * sym * leaf * leaf > 0
    masks = torch.where(plan.far_valid, plan.far_keys & 0xFF, 0)
    children = sum(int(((masks >> b) & 1).sum()) for b in range(8))
    assert grew["far.terms"] == evals * children * leaf
    assert grew["host_reads"] == 1
    assert found["host_read"] == 1
    assert found["bh.near"] >= evals and found["bh.far"] >= evals


# The benchmark's 1M spheres on which budgets calibrated at t = 0 and one
# step on clipped within a few calls before the step callables healed them
# (PERF.md §7.1).
HEAL_SEEDS = (3000000104, 3000000402, 3000000501, 2147600002, 2147600005,
              2147600006, 2147600007)
# Budgets at which no list of these spheres clips: the list functions clamp
# each to its list's full width.
FULL_WIDTH = {"bh_near_budget": 1 << 20, "bh_far_budget": 1 << 20,
              "bh_cand2_budget": 1 << 20, "bh_cand_budget": 1 << 20}


def _sphere_1m(seed, device):
    from benchmark.inputs import plummer
    from parallelnbody_tpu_torch.state import make_state

    pos, vel, mass = plummer.sphere(1 << 20, seed)
    return make_state(pos, vel, mass, seed=seed, device=device,
                      dtype="float32")


@pytest.mark.parametrize("k,calls", [(8, 4), (1, 24)])
def test_calibrated_budgets_heal_on_the_card(cuda, k, calls):
    """The seven spheres at 1M, auto budgets, Simulation.step(k): overflow
    0 on every call, and the state bit-equal to the same calls at budgets
    of full width. The heals each call took are printed (one line a
    seed)."""
    import json

    from parallelnbody_tpu_torch.kernels.launch import COUNTERS

    base = dict(n=1 << 20, force="barnes_hut", theta=0.72, bh_multipole=2,
                track_potential=False, dt=1e-4, softening=0.01,
                bh_rebuild_every=8)
    for seed in HEAL_SEEDS:
        state = _sphere_1m(seed, cuda)
        sim = Simulation(SimConfig(**base), cuda, state=state)
        wide = Simulation(SimConfig(**base, **FULL_WIDTH), cuda, state=state)
        assert torch.equal(sim.state.acc, wide.state.acc)
        heals = []
        for _ in range(calls):
            before = COUNTERS["bh.heals"]
            sim.step(k)
            heals.append(COUNTERS["bh.heals"] - before)
            assert int(sim.overflow) == 0, (seed, len(heals))
            wide.step(k)
        assert int(wide.overflow) == 0
        for f in ("pos", "vel", "acc"):
            assert torch.equal(getattr(sim.state, f),
                               getattr(wide.state, f)), (seed, f)
        print(json.dumps({"seed": seed, "k": k, "heals_per_call": heals,
                          "calibrated": {f: getattr(sim.cfg, f)
                                         for f in FULL_WIDTH}}))


def _launch_calls(call, state):
    """(runtime calls that put work on the device, host reads) of one call
    under torch.profiler (the benchmark's launches_per_step count)."""
    from torch.profiler import ProfilerActivity, profile

    from parallelnbody_tpu_torch.kernels.launch import COUNTERS

    device_calls = {"cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                    "cudaMemsetAsync"}
    reads = COUNTERS["host_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(state)
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.name in device_calls)
    return n, COUNTERS["host_reads"] - reads


@pytest.mark.parametrize("k", [8, 1])
def test_heal_adds_no_launch_or_read_to_a_run_that_never_clips(cuda, k):
    """At 1M on the program's own Plummer ICs (nothing clips), the step
    callable with the heal (calibrated budgets) makes the same device
    calls and host reads as the same budgets set by the caller (no heal),
    and gives the same state."""
    from parallelnbody_tpu_torch import api

    cfg = SimConfig(n=1 << 20, force="barnes_hut", theta=0.72,
                    bh_multipole=2, track_potential=False, dt=1e-4, seed=3)
    cal, state = api.prepare_simulation(cfg, cuda)
    plain = cal.replace(**{f: getattr(cal, f)
                           for f in cal.calibrated_budgets})
    got = []
    for c in (cal, plain):
        call = (api.make_step(c, report_overflow=True) if k == 1
                else api.make_run(c, k, report_overflow=True))
        out, of = call(state)                # warm-up
        assert int(of) == 0
        got.append((_launch_calls(call, state), call(state)[0]))
    assert got[0][0] == got[1][0]
    assert got[0][0][1] == 1       # one read a list build: K1's item sizes
    for f in ("pos", "vel", "acc"):
        assert torch.equal(getattr(got[0][1], f), getattr(got[1][1], f))
