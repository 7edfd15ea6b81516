"""The port's tracing (utils/profiling.py: span, tracing, take_spans,
self_times) and counters (kernels/launch.py) on the CPU: the span tree of
a direct step, of Barnes-Hut steps (dense, staged) and of a rebuild-2 run;
the counters against counts made independently from N and from the lists'
masks; tracing off leaving no record and no profiler range; traced steps
equal to untraced ones bit for bit; the CLI's records under --profile-dir;
the tracing-cost tool's reductions. The card's side (launches and copies
inside their spans on the profiler's clock) is in tests/test_torch_gpu.py.
"""

import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from parallelnbody_tpu_torch import SimConfig, api
from parallelnbody_tpu_torch.cli import main as cli_main
from parallelnbody_tpu_torch.kernels import launch
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import trace_cost
from parallelnbody_tpu_torch.utils import profiling

torch.set_num_threads(2)

DIRECT = SimConfig(n=512, force="direct_pallas", seed=1, dt=1e-3)
BH = {
    "dense": SimConfig(n=4096, force="barnes_hut", seed=2, dt=1e-3,
                       bh_leaf_size=16, bh_refine="dense", bh_multipole=2,
                       theta=0.6),
    "staged": SimConfig(n=4096, force="barnes_hut", seed=2, dt=1e-3,
                        bh_leaf_size=16, bh_refine="staged",
                        bh_multipole=2, theta=0.6),
}
BH_SPANS = {"bh.sort", "bh.tree", "bh.traverse", "bh.lists", "bh.far",
            "bh.near", "bh.unsort"}


@pytest.fixture(scope="module")
def prepared():
    """{name: (cfg, state)} prepared on the CPU, tracing off."""
    out = {"direct": api.prepare_simulation(DIRECT, "cpu")}
    for name, cfg in BH.items():
        out[name] = api.prepare_simulation(cfg, "cpu")
    return out


def traced(fn, *args):
    """(fn(*args), its spans, the counters' growth) with tracing on."""
    profiling.take_spans()
    before = launch.read_counters()
    with profiling.tracing(True):
        out = fn(*args)
    after = launch.read_counters()
    return out, profiling.take_spans(), {k: after[k] - before[k]
                                         for k in after}


def parents(spans):
    """{span name: set of its parents' names} (None: a call's first)."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        parent = by_id[s.parent].name if s.parent in by_id else None
        out.setdefault(s.name, set()).add(parent)
    return out


def plan_counts(cfg, pos, mass):
    """(near entries, accepted far children, leaf size) of the octet lists
    the configuration builds at pos, counted from the plan's masks."""
    leaf = cfg.resolve_bh_leaf_size()
    _, _, _, tree, _, _ = bh._prepare(
        pos, mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    refine, cands = bh.resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        tree.n_levels, cfg.resolve_bh_near_budget(),
        cfg.resolve_bh_far_budget())
    plan = bh.bh_plan_lists(
        tree, theta=cfg.theta, near_budget=cfg.resolve_bh_near_budget(),
        far_budget=cfg.resolve_bh_far_budget(), refine=refine,
        cand_budgets=cands, dtype=pos.dtype, leaf_size=leaf)
    masks = torch.where(plan.far_valid, plan.far_keys & 0xFF, 0)
    children = sum(int(((masks >> b) & 1).sum()) for b in range(8))
    return int(plan.near_valid.sum()), children, leaf


def test_span_tree_of_a_direct_step(prepared):
    cfg, state = prepared["direct"]
    _, spans, grew = traced(api.make_step(cfg), state)
    assert parents(spans) == {"api.step": {None}, "integrator": {"api.step"},
                              "force": {"integrator"}, "k3": {"force"}}
    assert len({s.call for s in spans}) == 1
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert grew["k3.pairs"] == cfg.n * cfg.n
    assert grew["host_reads"] == 0 and grew["k1.pair_terms"] == 0


@pytest.mark.parametrize("refine", sorted(BH))
def test_span_tree_of_a_barnes_hut_step(prepared, refine):
    cfg, state = prepared[refine]
    out, spans, grew = traced(api.make_step(cfg), state)
    tree = parents(spans)
    assert set(tree) == BH_SPANS | {"api.step", "integrator", "force",
                                    "bh.keys"}
    assert tree["api.step"] == {None}
    assert tree["integrator"] == {"api.step"}
    assert tree["force"] == {"integrator"}
    assert tree["bh.keys"] == {"bh.sort"}
    for name in BH_SPANS:
        assert tree[name] == {"force"}, name
    assert len({s.call for s in spans}) == 1
    # The force ran at the step's drifted positions: the output's.
    entries, children, leaf = plan_counts(cfg, out.pos, out.mass)
    assert grew["k1.pair_terms"] == entries * leaf * leaf > 0
    assert grew["far.terms"] == children * leaf > 0
    assert grew["host_reads"] == 0 and grew["k3.pairs"] == 0
    assert grew["bh.pot_evals"] == 1


def test_span_tree_of_a_rebuild_run(prepared):
    cfg, state = prepared["dense"]
    cfg = cfg.replace(bh_rebuild_every=2)
    _, spans, grew = traced(api.make_run(cfg, 2), state)
    tree = parents(spans)
    assert tree == {
        "api.run": {None}, "api.block": {"api.run"},
        "bh.unsort": {"api.run"}, "bh.sort": {"api.block"},
        "bh.keys": {"bh.sort"},
        "bh.tree": {"api.block"}, "bh.traverse": {"api.block"},
        "bh.lists": {"api.block"}, "integrator": {"api.block"},
        "force": {"integrator"}, "bh.refresh": {"force"},
        "bh.far": {"force"}, "bh.near": {"force"}}
    assert sum(s.name == "api.block" for s in spans) == 1
    assert sum(s.name == "force" for s in spans) == 2
    assert len({s.call for s in spans}) == 1
    # One list build at the start positions, evaluated twice.
    entries, _, leaf = plan_counts(cfg, state.pos, state.mass)
    assert grew["k1.pair_terms"] == 2 * entries * leaf * leaf
    assert grew["host_reads"] == 0
    assert grew["bh.pot_evals"] == 2


def test_calls_get_their_own_ids(prepared):
    cfg, state = prepared["direct"]
    step = api.make_step(cfg)
    _, spans, _ = traced(lambda s: step(step(s)), state)
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["api.step", "api.step"]
    assert {s.call for s in spans} == {s.id for s in roots}


def test_prepare_spans():
    _, spans, _ = traced(api.prepare_simulation, DIRECT, "cpu")
    assert parents(spans) == {
        "api.prepare": {None}, "api.calibrate": {"api.prepare"},
        "api.initial_forces": {"api.prepare"}, "force": {"api.initial_forces"},
        "k3": {"force"}}


def test_tracing_off_leaves_no_record_and_no_range(prepared):
    cfg, state = prepared["direct"]
    spans = {"api.step", "integrator", "force", "k3"}
    profiling.take_spans()
    assert not profiling.is_tracing()
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.make_step(cfg)(state)
    assert profiling.take_spans() == []
    assert not {e.name for e in prof.events()} & spans
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.tracing(True):
        api.make_step(cfg)(state)
    assert not profiling.is_tracing()
    assert spans <= {e.name for e in prof.events()}
    assert {s.name for s in profiling.take_spans()} == spans


def test_tracing_setter_and_context():
    profiling.tracing(True)
    try:
        assert profiling.is_tracing()
        with profiling.tracing(False):
            assert not profiling.is_tracing()
        assert profiling.is_tracing()
    finally:
        profiling.tracing(False)
    assert not profiling.is_tracing()


@pytest.mark.parametrize("name", ["direct", "dense", "staged"])
def test_traced_step_equals_untraced(prepared, name):
    cfg, state = prepared[name]
    step = api.make_step(cfg, report_overflow=True)
    want, want_of = step(state)
    (got, got_of), _, _ = traced(step, state)
    for a, b in zip(want, got):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert torch.equal(want_of, got_of)


def test_self_times():
    S = profiling.Span
    spans = [S("b", 1, 0, 0, 10, 30), S("c", 2, 0, 0, 40, 50),
             S("a", 0, -1, 0, 0, 100), S("d", 3, 9, 9, 0, 5)]
    got = profiling.self_times(spans)
    assert got == pytest.approx({"a": 70e-9, "b": 20e-9, "c": 10e-9,
                                 "d": 5e-9})


def test_cli_profile_dir_logs_interactions_and_host_reads(tmp_path, capsys):
    assert cli_main([
        "run", "--n", "1024", "--steps", "4", "--force", "barnes_hut",
        "--bh-leaf-size", "32", "--log-every", "2", "--quiet",
        "--metrics", str(tmp_path / "m.jsonl"),
        "--profile-dir", str(tmp_path / "prof"), "--device", "cpu"]) == 0
    capsys.readouterr()
    records = [json.loads(line) for line in
               (tmp_path / "m.jsonl").read_text().splitlines()]
    # The first record carries set-up's split, from its spans.
    first = records[0]
    assert first["prepare_s"] >= first["calibrate_s"] + first[
        "initial_forces_s"] > 0
    assert first["calibrate_s"] > 0 and first["initial_forces_s"] > 0
    logged = [r for r in records if "steps_per_sec" in r]
    assert len(logged) == 2
    for r in logged:
        assert r["interactions_per_sec"] > 0
        assert r["host_reads_per_step"] == 0
        assert r["bh_heals"] == 0
        # The CPU runs the plain near field: no mutual form.
        assert r["k1_pair_terms"] > 0 and r["k1_sym_terms"] == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"api.run", "bh.near", "bh.far"} <= names
    assert not profiling.is_tracing()
    # Without --profile-dir the records are as before.
    assert cli_main([
        "run", "--n", "256", "--steps", "2", "--force", "direct",
        "--log-every", "2", "--quiet", "--metrics",
        str(tmp_path / "plain.jsonl"), "--device", "cpu"]) == 0
    plain = [json.loads(line) for line in
             (tmp_path / "plain.jsonl").read_text().splitlines()]
    assert "prepare_s" not in plain[0]
    assert "steps_per_sec" in plain[-1]
    assert "interactions_per_sec" not in plain[-1]


def test_trace_cost_tool_on_cpu(tmp_path, capsys):
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(DIRECT.to_json())
    trace_cost.main(["--config", str(cfg_file), "--calls", "2",
                     "--rounds", "1", "--device", "cpu"])
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["mode"] for r in recs] == ["off", "on", "profile"]
    on = recs[1]
    assert set(on["self_ms_per_step"]) == {"api.step", "integrator",
                                           "force", "k3"}
    assert on["shell_host_ms_per_step"] == on["self_ms_per_step"]["api.step"]
    assert on["integrator_host_ms_per_step"] > 0
    assert "step_idle_share" not in recs[2]


def test_idle_in_spans_on_made_up_events():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, device, start_us, end_us):
        return types.SimpleNamespace(
            name=name, device_type=device,
            time_range=types.SimpleNamespace(start=start_us, end=end_us))

    events = [
        ev("api.step", cpu, 0, 100), ev("api.step", cpu, 200, 260),
        ev("api.step", cuda, 0, 300),        # the span's device copy
        ev("k", cuda, 30, 150), ev("copy", cuda, 140, 160),
        ev("k", cuda, 250, 400), ev("force", cpu, 10, 90),
    ]
    idle, window = trace_cost.idle_in_spans(events, {"api.step", "force"})
    # Idle inside the spans: 0-30 in the first, 200-250 in the second.
    assert idle == pytest.approx(80e-6)
    assert window == pytest.approx(400e-6)
    # A make_run call that steps through make_step: each api.step lies
    # inside the api.run, and its idle counts once.
    nested = [
        ev("api.run", cpu, 0, 260), ev("api.step", cpu, 0, 100),
        ev("api.step", cpu, 200, 260), ev("api.run", cuda, 0, 300),
        ev("k", cuda, 30, 150), ev("k", cuda, 250, 400),
    ]
    idle, window = trace_cost.idle_in_spans(nested, {"api.run", "api.step"})
    # Idle inside the run: 0-30 and 150-250.
    assert idle == pytest.approx(130e-6)
    assert window == pytest.approx(400e-6)
