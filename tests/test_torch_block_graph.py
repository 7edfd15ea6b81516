"""A rebuild block's geometry through a BlockGraph (ops/bh.py
`_graphed_block`, `BlockGraph`): on the card the sort, the pyramid, the
traversal and the lists of a one-window block are captured once as a CUDA
graph and replayed. Off the card the graph is stood in for:

  * `_graphed_block` with a stand-in that runs the geometry each time gives
    the rows and the plan of the block built op by op, bit for bit, with
    budgets that never clip and with calibrated budgets that clip and heal
    (the heal asks for the second set of budgets under a key of its own);
  * `BlockGraph.run` runs the run's first build, captures the second,
    replays every later one at its key after copying the input columns
    in, and captures anew at another key (the capture, `bh._captured`,
    stood in for).

Plummer spheres of the benchmark's sampler, N = 4096 at leaf 16 (256
leaves), dense and staged lists. The card test
`tests/test_torch_gpu.py::test_block_graph_replays_the_plain_block` holds
the captured graph to the ops run one by one."""

import pytest
import torch

from benchmark.inputs import plummer
from parallelnbody_tpu_torch import SimConfig, api
from parallelnbody_tpu_torch.kernels.launch import COUNTERS
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.state import make_state

torch.set_num_threads(2)

SEED = 2**31 + 2341
N = 4096
SMALL = {"bh_near_budget": 4, "bh_far_budget": 4, "bh_cand2_budget": 8,
         "bh_cand_budget": 8}


@pytest.fixture(scope="module", params=["dense", "staged"])
def prepared(request):
    """(calibrated cfg, its block's input columns, its setup)."""
    cfg = SimConfig(n=N, force="barnes_hut", theta=0.5, bh_curve="morton",
                    bh_multipole=2, bh_leaf_size=16, bh_refine=request.param,
                    dt=1e-3, softening=0.01, bh_rebuild_every=8)
    pos, vel, mass = plummer.sphere(N, SEED)
    state = make_state(pos, vel, mass, seed=SEED, device="cpu",
                       dtype="float32")
    cal, state = api.prepare_simulation(cfg, "cpu", state=state)
    setup = bh.BHSetup.of(cal)
    pad = setup.n_pad - N
    z3 = state.pos.new_zeros((pad, 3))
    cols = (torch.cat([state.pos, z3]), torch.cat([state.vel, z3]),
            torch.cat([state.acc, z3]),
            torch.cat([state.mass, state.mass.new_zeros(pad)]),
            torch.arange(setup.n_pad, dtype=torch.int32))
    return cal, cols, setup


class StandIn:
    """BlockGraph's contract off the card: each build runs its geometry;
    the keys it was asked for are kept."""

    def __init__(self):
        self.keys = []

    def run(self, fn, cols, key):
        self.keys.append(key)
        return fn(cols)


@pytest.mark.parametrize("budgets", ["calibrated", "clipping"])
def test_graphed_block_is_the_plain_block(prepared, budgets):
    cal, cols, setup = prepared
    if budgets == "clipping":
        cal = cal.calibrated(**SMALL)
        setup = bh.BHSetup.of(cal)
    heals = COUNTERS["bh.heals"]
    rows, plan, _ = bh.rebuild_block(*cols, setup, N, bh.ListHeal.of(cal))
    healed = COUNTERS["bh.heals"] - heals
    stand_in = StandIn()
    heal = bh.ListHeal.of(cal)
    rows_g, plan_g, _ = bh.rebuild_block(*cols, setup, N, heal, stand_in)
    assert COUNTERS["bh.heals"] - heals == 2 * healed
    assert (healed > 0) == (budgets == "clipping")
    assert len(stand_in.keys) == 1 + healed
    assert stand_in.keys[0] == tuple(sorted(setup.budgets().items()))
    if healed:
        assert stand_in.keys[-1] == tuple(sorted(
            {**setup.budgets(), **heal.grown}.items()))
    for a, b in zip(rows, rows_g):
        assert torch.equal(a, b)
    for name in ("near_idx", "near_valid", "far_keys", "far_valid",
                 "overflow"):
        assert torch.equal(getattr(plan, name), getattr(plan_g, name)), name
    assert int(plan_g.overflow) == 0


def test_block_graph_runs_captures_then_replays(monkeypatch):
    """The run's first build runs, the second is captured and replayed
    once, each later one at its key copies the columns in and replays;
    another key is captured at once in the old graph's pool, the old graph
    gone."""
    graphs = []

    class Graph:
        def __init__(self, pool):
            self.replays, self.shares = 0, pool
            graphs.append(self)

        def replay(self):
            self.replays += 1

        def pool(self):
            return ("pool of", self)

    monkeypatch.setattr(bh, "_captured",
                        lambda fn, cols, pool: (Graph(pool), fn(cols)))
    seen = []

    def fn(cols):
        seen.append(cols)
        return cols[0] * 2

    g = bh.BlockGraph()
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    assert torch.equal(g.run(fn, (a,), "k"), a * 2)
    assert seen[-1][0] is a and not graphs
    out = g.run(fn, (a,), "k")
    assert len(graphs) == 1 and graphs[0].replays == 1
    assert seen[-1][0] is not a and torch.equal(seen[-1][0], a)
    assert g.run(fn, (b,), "k") is out and len(seen) == 2
    assert graphs[0].replays == 2 and torch.equal(g.cols[0], b)
    assert torch.equal(g.run(fn, (b,), "j"), b * 2) and len(seen) == 3
    assert len(graphs) == 2 and g.key == "j" and graphs[1].replays == 1
    assert torch.equal(g.cols[0], b) and g.cols[0] is not b
    assert graphs[0].shares is None
    assert graphs[1].shares == ("pool of", graphs[0])
