"""Card measurements behind the port's auto rules, on one CUDA device.

    python3 -m parallelnbody_tpu_torch.tools.auto_rules [--only NAME ...]
        [--out FILE]

Each measurement prints JSON lines, every one with the card's name and
power limit as nvidia-smi gives them. Times are ms/step by CUDA events
after a warm-up. Every timed run starts from the same t = 0 state, with
the auto budgets raised to cover the states the longest run reaches
(`_prepared`), so that both sides of a rule do the work their configuration
states: a row whose timed runs clipped a list entry raises. The
all-pairs / Barnes-Hut crossover is measured by chip_smoke.py's
phase_crossover, not here.

  plan_eval   the rebuild-block cost model of api._reuse_block_size: one
              block's plan (Hilbert sort, multipole pyramid, traversal and
              lists with K1's work items and K2's launch order) against one
              frozen-list evaluation (bh_eval_lists), split by
              tools/reuse_probe.py's make_plan_eval, at N = 1M dense
              (examples/barneshut_1m_reuse.json) and N = 8M staged
              (examples/barneshut_8m.json). Behind
              api._REUSE_PLAN_RATIO["cuda"].
  block       a run of BLOCK_STEPS steps, a length at which the CPU's plan
              ratio and the card's pick different block sizes, at each
              block size, on the same two configs, alternated ABBA.
  leaf        leaf 128 against 256 at N = 2^20 .. 2^23 (the rule
              SimConfig.resolve_bh_leaf_size, by device), two runs of each
              in the order 128, 256, 256, 128: step(1) and step(16) (two
              rebuild blocks of 8), on the shipped Plummer config
              (RULE_CONFIG) at each N, with the refinement each side
              resolves to, its sections, peak device memory and the
              sampled rms force error (k = 4096) of the states after
              step(1) and after step(16).
  calib       the budget calibration that Simulation gets on the card:
              each of CALIB_CASES at leaf 128 and 256, its auto budgets
              calibrated on the t = 0 state alone (the CPU's rule) and by
              prepare_simulation (also one step on), then CALIB_STEPS
              steps: the list overflow summed after each call.
  refine      dense against staged refinement at 4096, 8192 and 16384
              leaves of 256 (the rule SimConfig.resolve_bh_refine: staged
              from 8192 leaves), with each run's peak device memory, on
              the same config.
  floor       K3 against the plain direct sum at N = 128 .. 2048 (the rule
              SimConfig.resolve_force: K3 on a CUDA device from N = 512).

`--out` appends the lines to FILE as well.
"""

from __future__ import annotations

import argparse
import gc
import json
import os

import torch

from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.api import (_REUSE_PLAN_RATIO,
                                         _fill_initial_forces,
                                         _reuse_block_size, calibrate_budgets,
                                         init_simulation, make_run,
                                         prepare_simulation)
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools import measure
from parallelnbody_tpu_torch.tools.reuse_probe import make_plan_eval
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEP_REPS = 5
PLAN_CONFIGS = ("examples/barneshut_1m_reuse.json",
                "examples/barneshut_8m.json")
PLAN_REPS = 3
# The leaf and refine rows: the shipped 1M Plummer config (theta 0.72,
# dt 1e-4, no potential) at each N.
RULE_CONFIG = "examples/barneshut_1m_reuse.json"
BLOCK_STEPS = 33        # 0.3 picks blocks of 3 (11 blocks), 0.5 of 7 (5)
BLOCK_REPS = 2          # ABBA pairs
LEAF_N = (1 << 20, 1 << 21, 1 << 22, 1 << 23)
LEAF_ORDER = (128, 256, 256, 128)   # two runs of each, in turns
RMS_K = 4096
LEAF_STEP_REPS = 10      # per-step Barnes-Hut moves a few % within a run
REFINE_N = (1 << 20, 1 << 21, 1 << 22)   # 4096, 8192, 16384 leaves of 256
FLOOR_N = (128, 256, 512, 1024, 2048)
CALIB_CASES = (("SimConfig(n=2^20)", None, 1 << 20),
               ("SimConfig(n=2^21)", None, 1 << 21),
               (RULE_CONFIG, RULE_CONFIG, None),
               ("examples/galaxy_2m.json", "examples/galaxy_2m.json", None))
CALIB_STEPS = (1, 1, 1, 1, 16, 16)
GIB = 2**30
# The list budgets that 0 leaves to calibration.
AUTO_BUDGET_FIELDS = tuple(bh.BUDGET_FIELDS.values())


def _events_ms(fn, reps):
    """Mean device time in ms of reps calls of fn(), by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _load(path):
    with open(os.path.join(ROOT, path)) as f:
        return SimConfig.from_json(f.read())


def recalibrate_on_overflow(cfg, state, auto_fields):
    """cfg with each budget of auto_fields (fields that arrived as 0 =
    auto) raised to what calibrate_budgets measures on `state`, where that
    is more: only upward, and explicit budgets never. Returns (cfg, grew),
    grew mapping the raised fields to their new values ({} = nothing to
    do); the raised fields stay calibrated."""
    fresh = calibrate_budgets(cfg.replace(**{f: 0 for f in auto_fields}),
                              state)
    grew = {f: getattr(fresh, f) for f in auto_fields
            if getattr(fresh, f) > getattr(cfg, f)}
    return (cfg.calibrated(**grew) if grew else cfg), grew


def _prepared(cfg, steps):
    """(cfg, t = 0 state): prepare_simulation on the card, then the auto
    budgets raised (recalibrate_on_overflow) to cover the state after
    every step through `steps`, so that runs of up to `steps` from the
    returned state clip nothing that the configuration states. Every
    step: a single step's near lists can need several times the maximum
    of the states around it."""
    auto = [f for f in AUTO_BUDGET_FIELDS if getattr(cfg, f) == 0]
    cfg, state0 = prepare_simulation(cfg, "cuda")
    if cfg.resolve_force("cuda") == "barnes_hut" and auto:
        state = state0
        for _ in range(steps):
            state = make_run(cfg, 1)(state)
            cfg, _ = recalibrate_on_overflow(cfg, state, auto)
        del state
    return cfg, state0


def _budgets(cfg):
    return {f: getattr(cfg, f) for f in AUTO_BUDGET_FIELDS}


def _timed(run, state0, reps, totals):
    """Mean ms of reps calls of run(state0), adding each call's overflow
    to totals[0]."""
    got = []
    ms = _events_ms(lambda: got.append(run(state0)[1]), reps)
    totals[0] += sum(int(o) for o in got)
    return ms


def _gate(row):
    if row["overflow"]:
        raise AssertionError(f"clipped lists, the row compares unequal "
                             f"work: {row}")
    return row


def _sim_ms(cfg, reuse=False, rms=False, step_reps=STEP_REPS):
    """{"step1_ms", "step16_ms" (reuse), "overflow", "peak_gib", budgets}
    on the card; each length warmed up by one call, every call from the
    t = 0 state. rms: also "rms_step1" / "rms_step16", the sampled rms
    force error of the state each length reaches (after the peak memory is
    read: the direct sum's temporaries are not the run's)."""
    torch.cuda.reset_peak_memory_stats()
    lengths = (1, 16) if reuse else (1,)
    cfg, state0 = _prepared(cfg, lengths[-1])
    out, totals, ends = {}, [0], {}
    for k in lengths:
        run = make_run(cfg, k, report_overflow=True)
        ends[k] = run(state0)[0]
        out[f"step{k}_ms"] = _timed(run, state0, step_reps if k == 1 else 2,
                                    totals) / k
    out["overflow"] = totals[0]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    out.update(_budgets(cfg))
    for k, state in ends.items() if rms else ():
        out[f"rms_step{k}"] = rms_force_error_sample(
            state.pos, state.mass, state.acc, g=cfg.g,
            softening=cfg.softening, k=RMS_K)
    del state0, ends
    _free()
    return out


def plan_eval():
    for path in PLAN_CONFIGS:
        cfg, state = prepare_simulation(_load(path), "cuda")
        plan, evaluate, _, refine = make_plan_eval(cfg)
        pos_s, mass_s, _, lists = plan(state.pos, state.mass)   # warm-up
        evaluate(pos_s, mass_s, lists)
        plan_ms = _events_ms(lambda: plan(state.pos, state.mass), PLAN_REPS)
        eval_ms = _events_ms(lambda: evaluate(pos_s, mass_s, lists),
                             PLAN_REPS)
        yield _gate({"rule": "plan_eval", "config": path, "n": cfg.n,
                     "refine": refine, "plan_ms": plan_ms,
                     "eval_ms": eval_ms, "ratio": plan_ms / eval_ms,
                     "overflow": int(lists.overflow)})
        del state, pos_s, mass_s, lists
        _free()


def block():
    picks = {dev: _reuse_block_size(8, BLOCK_STEPS, ratio)
             for dev, ratio in _REUSE_PLAN_RATIO.items()}
    for path in PLAN_CONFIGS:
        cfg, state0 = _prepared(_load(path), BLOCK_STEPS)
        runs = {dev: make_run(cfg.replace(bh_rebuild_every=k), BLOCK_STEPS,
                              report_overflow=True)
                for dev, k in picks.items()}
        for run in runs.values():
            run(state0)
        ms = {dev: [] for dev in runs}
        totals = [0]
        for _ in range(BLOCK_REPS):
            for dev in (*runs, *reversed(runs)):
                ms[dev].append(_timed(runs[dev], state0, 1, totals)
                               / BLOCK_STEPS)
        yield _gate({"rule": "block", "config": path, "n": cfg.n,
                     "steps": BLOCK_STEPS,
                     **{f"k_{dev}": picks[dev] for dev in picks},
                     **{f"ms_{dev}": ms[dev] for dev in ms},
                     "overflow": totals[0], **_budgets(cfg)})
        del state0, runs
        _free()


def leaf():
    for n in LEAF_N:
        auto = SimConfig(n=n)
        for size in LEAF_ORDER:
            cfg = _load(RULE_CONFIG).replace(n=n, bh_leaf_size=size)
            setup = bh.BHSetup.of(cfg)
            yield _gate({"rule": "leaf", "n": n, "leaf": size,
                         "auto_leaf_cpu": auto.resolve_bh_leaf_size("cpu"),
                         "auto_leaf_cuda": auto.resolve_bh_leaf_size("cuda"),
                         "n_leaves": setup.n_leaves,
                         "refine": setup.refine, "sections": setup.sections,
                         **_sim_ms(cfg, reuse=True, rms=True,
                                   step_reps=LEAF_STEP_REPS)})


def refine():
    for n in REFINE_N:
        for mode in ("dense", "staged"):
            cfg = _load(RULE_CONFIG).replace(n=n, bh_leaf_size=256,
                                             bh_refine=mode)
            yield _gate({
                "rule": "refine", "n": n,
                "n_leaves": bh.BHSetup.of(cfg).n_leaves,
                "refine": mode,
                "auto": SimConfig(n=n, bh_leaf_size=256).resolve_bh_refine(),
                **_sim_ms(cfg, reuse=True)})


def calib():
    for name, path, n in CALIB_CASES:
        base = _load(path) if path else SimConfig(n=n)
        for size in (128, 256):
            cfg = base.replace(bh_leaf_size=size)
            for how in ("t0", "prepared"):
                if how == "t0":
                    state = init_simulation(cfg, "cuda",
                                            compute_forces=False)
                    run_cfg = calibrate_budgets(cfg, state)
                    state = _fill_initial_forces(run_cfg, state)
                else:
                    run_cfg, state = prepare_simulation(cfg, "cuda")
                total, after = 0, []
                for k in CALIB_STEPS:
                    state, of = make_run(run_cfg, k,
                                         report_overflow=True)(state)
                    total += int(of)
                    after.append(total)
                yield {"rule": "calib", "case": name, "leaf": size,
                       "calibrated": how,
                       "refine": run_cfg.resolve_bh_refine(),
                       "steps": list(CALIB_STEPS),
                       "overflow_after": after, **_budgets(run_cfg)}
                del state
                _free()


def floor():
    for n in FLOOR_N:
        row = {"rule": "floor", "n": n,
               "auto": SimConfig(n=n).resolve_force("cuda")}
        for force in ("direct", "direct_pallas"):
            row[force] = _sim_ms(SimConfig(n=n, force=force))["step1_ms"]
        yield row


RULES = {"plan_eval": plan_eval, "block": block, "leaf": leaf,
         "calib": calib, "refine": refine, "floor": floor}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=tuple(RULES),
                    default=list(RULES))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("auto_rules: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = measure.card()
    for name in args.only:
        for rec in RULES[name]():
            line = json.dumps({"card": card, **rec})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
