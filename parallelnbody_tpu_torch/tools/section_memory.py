"""Peak device memory and time of the staged Barnes-Hut path, unsectioned
and in target windows, on one CUDA device: the measurement behind the
sections auto threshold (ops/bh.py `_SECTION_AUTO_LEAVES`).

    python3 -m parallelnbody_tpu_torch.tools.section_memory \\
        [--config examples/barneshut_16m.json examples/barneshut_32m.json] \\
        [--sections 1 0] [--out FILE]

For each config and each section count (0 = the config's own auto) it
builds `Simulation(cfg)` (ICs, budget calibration, t = 0 forces), then
runs step(1) and step(16) (two rebuild blocks of 8 at the configs'
interval), each phase after a reset of the peak counter. It prints one JSON
line per run: the card's name and power limit, the resolved sections, the
peak `torch.cuda.max_memory_allocated` of each phase and its wall time
(synchronised), the peak reserved by step(16) (`max_memory_reserved`:
the caching allocator's pools, the rebuild block's CUDA graph among
them), the overflow count, and the calibrated budgets. `--out`
appends the lines to FILE as well.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from parallelnbody_tpu_torch import SimConfig, Simulation
from parallelnbody_tpu_torch.ops import bh
from parallelnbody_tpu_torch.tools.measure import card as card_name

GIB = 2**30


def peak_phase(fn, device="cuda"):
    """(result, peak GiB allocated while fn ran, wall s) of fn(); the peak
    is None off a CUDA device."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() / GIB if cuda else None,
            time.perf_counter() - t0)


def measure(path, sections):
    with open(path) as f:
        cfg = SimConfig.from_json(f.read())
    if sections:
        cfg = cfg.replace(bh_sections=sections)
    cfg = cfg.with_resolved_leaf("cuda")
    setup = bh.BHSetup.of(cfg)
    rec = {"config": path, "n": cfg.n, "n_leaves": setup.n_leaves,
           "bh_sections": cfg.bh_sections, "sections": setup.sections}
    sim, rec["init_gib"], rec["init_s"] = peak_phase(
        lambda: Simulation(cfg, device="cuda"))
    for k in (1, 16):
        _, rec[f"step{k}_gib"], rec[f"step{k}_s"] = peak_phase(
            lambda: sim.step(k))
    rec["step16_reserved_gib"] = torch.cuda.max_memory_reserved() / GIB
    rec["overflow"] = int(sim.overflow)
    rec["budgets"] = {f: getattr(sim.cfg, f) for f in (
        "bh_near_budget", "bh_far_budget", "bh_cand2_budget",
        "bh_cand_budget")}
    rec["state_gib"] = sum(t.numel() * t.element_size() for t in (
        sim.state.pos, sim.state.vel, sim.state.acc, sim.state.pot,
        sim.state.mass)) / GIB
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", nargs="+", default=[
        "examples/barneshut_16m.json", "examples/barneshut_32m.json"])
    ap.add_argument("--sections", nargs="+", type=int, default=[1, 0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("section_memory: needs a CUDA device")
    card = card_name()
    total = torch.cuda.get_device_properties(0).total_memory / GIB
    for path in args.config:
        for s in args.sections:
            rec = {"card": card, "total_gib": total, **measure(path, s)}
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
