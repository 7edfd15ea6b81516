"""The CUDA kernels K1 (near field), K2 (octet far field), K3 (all-pairs)
and K4 (gather far field) on the card.

Every test here is marked `gpu` and skips where torch.cuda.is_available()
is False. The file imports neither JAX nor the JAX package, so it also runs
on a machine that has the card and no JAX; tests/conftest.py imports JAX,
so run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs are the port's own Plummer ICs, trees and dense lists (octet and
gather), built on the CPU; the plain PyTorch versions of the kernels are
the reference.
Tolerance rtol 2e-4, atol 2e-5 (the bound of tests/test_bh.py for the
Pallas kernels against their jnp versions): kernel and plain version sum
the same f32 terms in another order, with another rsqrt.
"""

import numpy as np
import pytest
import torch

from parallelnbody_tpu_torch import Simulation, SimConfig
from parallelnbody_tpu_torch.api import init_simulation
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


@pytest.mark.parametrize("leaf", [16, 128, 256])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_kernel_leaf_sizes(cuda, leaf, compute_pot):
    """K1 holds 1, 4 and 8 targets a thread at leaf 16, 128 and 256 (a
    block is one warp from leaf 128 on); the work items built beforehand
    (near_work, as the paths build them) give the same bits as items built
    inside the call."""
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
    args = tuple(t.contiguous().to(cuda) for t in (
        pos_s, mass_s, pos_s.reshape(n_leaves, leaf, 3), ni, nv))
    kw = dict(g=1.5, softening=0.02, compute_pot=compute_pot)
    acc, pot = bh_kernels.near_field(*args, **kw)
    acc_p, pot_p = bh_kernels.near_field_plain(*args, **kw)
    _close(acc, acc_p)
    _close(pot, pot_p)
    acc_w, pot_w = bh_kernels.near_field(
        *args, work=bh_kernels.near_work(args[4]), **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_w) and torch.equal(pot, pot_w)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("kernel", ["near_field", "allpairs"])
def test_pair_kernels_repeat_bit_equal(lists, uneven_lists, kernel,
                                       softening):
    """K1 and K3 take no float atomics: two launches on the same inputs
    give the same bits."""
    if kernel == "near_field":
        def run():
            return bh_kernels.near_field(*uneven_lists, g=1.0,
                                         softening=softening)
    else:
        pos, mass = lists["pos_s"], lists["mass_s"]

        def run():
            return (direct_kernels.allpairs(pos, pos, mass,
                                            softening=softening),)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_rebuild_interval_plan_holds_the_work_items(cuda):
    """bh_plan_lists builds K1's work items once with the lists, so the
    frozen lists' evaluations wait on the host no more."""
    cfg = SimConfig(n=4096, ic="plummer", seed=2)
    state = init_simulation(cfg, cuda, compute_forces=False)
    pos_s, mass_s, _, tree, _, _ = bh._prepare(
        state.pos, state.mass, leaf_size=LEAF, curve="hilbert",
        multipole_order=2)
    plan = bh.bh_plan_lists(tree, theta=0.6, near_budget=64, far_budget=64,
                            refine="dense", cand_budgets=(0, 0),
                            dtype=torch.float32)
    assert int(plan.overflow) == 0
    want = bh_kernels.near_work(plan.near_valid)
    assert plan.near_work is not None
    assert torch.equal(plan.near_work.items, want.items)
    assert torch.equal(plan.near_work.splits, want.splits)
    assert plan.near_work.n_partial == want.n_partial


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
