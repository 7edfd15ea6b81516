#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parallelnbody_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. Environment: torch, CUDA and nvcc versions and the card's name and
     power limit. Exits with an error when torch.cuda.is_available() is
     False.
  2. Build: compiles the hand-written CUDA kernels from csrc/ (sm_90a).
  3. Kernel parity: K1 (near field) and K2 (octet far field) against their
     plain PyTorch versions on the card, at the lists of the N = 1M
     operating point (examples/barneshut_1m_reuse.json) and in full at
     N = 65536, for both potential settings, within rtol 2e-4 / atol 2e-5.
     Each kernel's time is taken beside its plain version's at the main
     path's shapes.
  4. Main path: Simulation(cfg, device="cuda") on that config, then
     step(1) (the per-step Barnes-Hut path) and step(16) (two rebuild
     blocks of 8). The launch counts of both kernels over that run must be
     above 0, the list overflow 0, every output finite, and the sampled rms
     force error against the direct sum below 2e-3. ms/step of both paths
     comes from CUDA events after a warm-up.

The last three lines of standard output are one JSON object with the
kernels' numbers, the nvidia-smi line of the card, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

from parallelnbody_tpu_torch import SimConfig, Simulation
from parallelnbody_tpu_torch.api import calibrate_budgets, init_simulation
from parallelnbody_tpu_torch.kernels import build
from parallelnbody_tpu_torch.ops import bh, bh_kernels
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "barneshut_1m_reuse.json")
RTOL, ATOL = 2e-4, 2e-5     # the Pallas-vs-jnp kernel bound of tests/test_bh.py
RMS_BOUND = 2e-3            # the accuracy class of the N=1M operating point
RMS_SAMPLES = 4096
SAMPLE_ROWS = 64            # target leaves of the 1M lists held with the potential
PARITY_N = 65536            # second, full-size parity point
KERNEL_REPS = 10
STEP_REPS = 3
REUSE_STEPS = 16
DEVICE = "cuda"

KERNELS = {
    "near_field": ("parallelnbody_tpu_torch/csrc/near_field.cu",
                   "parallelnbody_tpu/ops/pallas_bh.py:179"),
    "far_octet": ("parallelnbody_tpu_torch/csrc/far_octet.cu",
                  "parallelnbody_tpu/ops/pallas_bh.py:382"),
}


def log(msg=""):
    print(msg, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_environment():
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs one CUDA device")
    nvcc = build.find_nvcc()
    log(f"nvcc {nvcc}: {run([nvcc, '--version']).splitlines()[-1]}")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    log(f"device 0: {torch.cuda.get_device_name(0)}  "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    # Plain versions run einsum through matmul: keep it in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"  {line.strip()}")


def cuda_ms(fn, reps=1):
    """(last result, mean device time in ms) of reps calls of fn(), by
    CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def max_err(name, got, want):
    """Max |got - want| over the pair of outputs; raises beyond
    atol + rtol * |want| or on a non-finite value."""
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (g - w).abs()
        bad = err > ATOL + RTOL * w.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} values beyond rtol {RTOL} / atol "
                f"{ATOL}; max abs err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    return worst


def lists_for(cfg, state):
    """The dense-octet lists of the per-step path (bh.bh_accel) for
    cfg (calibrated budgets) at state."""
    leaf = cfg.resolve_bh_leaf_size()
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    n_leaves = n_pad // leaf
    far, rej = bh.traverse(tree, cfg.theta)
    ni, nv, fk, fv, nodes8, of = bh.build_interaction_lists_octet(
        tree, far, rej, theta=cfg.theta, start_leaf=0, n_slice=n_leaves,
        near_budget=cfg.resolve_bh_near_budget(),
        far_budget=cfg.resolve_bh_far_budget(), dtype=torch.float32)
    if int(of) != 0:
        raise AssertionError(f"list overflow {int(of)} at calibrated budgets")
    return dict(pos_s=pos_s, mass_s=mass_s,
                tgt=pos_s.reshape(n_leaves, leaf, 3), ni=ni, nv=nv, fk=fk,
                fv=fv, nodes8=nodes8)


def near_args(L, rows=None):
    if rows is None:
        return L["pos_s"], L["mass_s"], L["tgt"], L["ni"], L["nv"]
    return (L["pos_s"], L["mass_s"], L["tgt"][rows].contiguous(),
            L["ni"][rows].contiguous(), L["nv"][rows].contiguous())


def far_args(L, rows=None):
    if rows is None:
        return L["tgt"], L["nodes8"], L["fk"], L["fv"]
    return (L["tgt"][rows].contiguous(), L["nodes8"],
            L["fk"][rows].contiguous(), L["fv"][rows].contiguous())


def phase_kernel_parity(cfg_json):
    dev = torch.device(DEVICE)
    funcs = {"near_field": (bh_kernels.near_field, bh_kernels.near_field_plain,
                            near_args),
             "far_octet": (bh_kernels.far_octet, bh_kernels.far_octet_plain,
                           far_args)}
    out = {name: {"max_abs_err": 0.0} for name in funcs}

    cfg = SimConfig.from_json(cfg_json)
    t0 = time.perf_counter()
    state = init_simulation(cfg, dev, compute_forces=False)
    cfg = calibrate_budgets(cfg, state)
    L = lists_for(cfg, state)
    torch.cuda.synchronize()
    n_leaves = L["tgt"].shape[0]
    log(f"N={cfg.n}: {n_leaves} leaves of {cfg.resolve_bh_leaf_size()}, "
        f"budgets near {cfg.bh_near_budget} far {cfg.bh_far_budget}; "
        f"near entries mean {float(L['nv'].sum(1).float().mean()):.1f} max "
        f"{int(L['nv'].sum(1).max())}; far octets mean "
        f"{float(L['fv'].sum(1).float().mean()):.1f} max "
        f"{int(L['fv'].sum(1).max())} ({time.perf_counter() - t0:.1f} s)")
    kw = dict(g=cfg.g, softening=cfg.softening)
    rows = torch.linspace(0, n_leaves - 1, SAMPLE_ROWS, device=dev).long()

    for name, (kernel, plain, args) in funcs.items():
        rec = out[name]
        # The main path's setting (track_potential=False) at its shapes.
        full = args(L)
        got = kernel(*full, compute_pot=False, **kw)
        plain(*args(L, rows), compute_pot=False, **kw)      # warm-up
        want, rec["plain_ms"] = cuda_ms(
            lambda: plain(*full, compute_pot=False, **kw))
        err = max_err(f"{name} N={cfg.n} full", got, want)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del want
        kernel(*full, compute_pot=False, **kw)               # warm-up
        _, rec["ms"] = cuda_ms(lambda: kernel(*full, compute_pot=False, **kw),
                               KERNEL_REPS)
        log(f"{name} at N={cfg.n} (compute_pot=False): kernel "
            f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms; full max "
            f"abs err {rec['max_abs_err']:.3e}")
        # With the potential, on a sample of target leaves.
        sub = args(L, rows)
        err = max_err(f"{name} N={cfg.n} {SAMPLE_ROWS} rows pot",
                      kernel(*sub, compute_pot=True, **kw),
                      plain(*sub, compute_pot=True, **kw))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"{name} at N={cfg.n}, {SAMPLE_ROWS} sampled target leaves "
            f"(compute_pot=True): max abs err {err:.3e}")
    del L, state

    # Full parity at a second size, both potential settings.
    small = SimConfig.from_json(cfg_json).replace(n=PARITY_N)
    state = init_simulation(small, dev, compute_forces=False)
    small = calibrate_budgets(small, state)
    L = lists_for(small, state)
    for name, (kernel, plain, args) in funcs.items():
        for compute_pot in (True, False):
            err = max_err(f"{name} N={PARITY_N} pot={compute_pot}",
                          kernel(*args(L), compute_pot=compute_pot, **kw),
                          plain(*args(L), compute_pot=compute_pot, **kw))
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            log(f"{name} at N={PARITY_N} (compute_pot={compute_pot}): "
                f"max abs err {err:.3e}")
    return out


def phase_main_path(cfg_json):
    cfg = SimConfig.from_json(cfg_json)
    n = cfg.n

    bh_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulation(cfg, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    state1 = sim.step(1)
    torch.cuda.synchronize()
    t_step1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    state17 = sim.step(REUSE_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(bh_kernels.LAUNCHES)
    overflow = int(sim.overflow)
    log(f"Simulation init {t_init:.2f} s (calibrated budgets near "
        f"{sim.cfg.bh_near_budget} far {sim.cfg.bh_far_budget}); first "
        f"step(1) {t_step1:.2f} s; first step({REUSE_STEPS}) {t_run:.2f} s")
    log(f"main-path launches {launches}; overflow {overflow}")

    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if overflow != 0:
        raise AssertionError(f"list overflow {overflow} on the main path")
    if int(state17.step) != 1 + REUSE_STEPS:
        raise AssertionError(f"step counter {int(state17.step)}")
    for label, s in (("step(1)", state1), (f"step({REUSE_STEPS})", state17)):
        for field in ("pos", "vel", "acc"):
            t = getattr(s, field)
            if tuple(t.shape) != (n, 3) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label}: {field} {tuple(t.shape)} "
                                     "not finite or of the wrong shape")

    rms = {}
    for label, s in (("per_step", state1), ("reuse", state17)):
        rms[label] = rms_force_error_sample(
            s.pos, s.mass, s.acc, g=cfg.g, softening=cfg.softening,
            k=RMS_SAMPLES)
        log(f"rms force error vs direct sum after {label} "
            f"(k={RMS_SAMPLES}): {rms[label]:.4e}")
        if not rms[label] < RMS_BOUND:
            raise AssertionError(f"{label} rms {rms[label]:.4e} >= "
                                 f"{RMS_BOUND}")

    _, ms_step = cuda_ms(lambda: sim.step(1), STEP_REPS)
    _, ms_block = cuda_ms(lambda: sim.step(REUSE_STEPS))
    ms_reuse = ms_block / REUSE_STEPS
    log(f"ms/step at N={n}: per-step {ms_step:.2f} (mean of {STEP_REPS} "
        f"step(1)), rebuild every {cfg.bh_rebuild_every} {ms_reuse:.2f} "
        f"(step({REUSE_STEPS}))")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    diag = sim.diagnostics()
    log("diagnostics " + json.dumps(diag))
    if not all(math.isfinite(v) for v in diag.values()):
        raise AssertionError("non-finite diagnostics")
    return launches


def main():
    smi = phase_environment()
    with open(CONFIG) as f:
        cfg_json = f.read()
    phase_build()
    kernels = phase_kernel_parity(cfg_json)
    launches = phase_main_path(cfg_json)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
