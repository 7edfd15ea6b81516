#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parallelnbody_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. Environment: torch, CUDA and nvcc versions and the card's name and
     power limit. Exits with an error when torch.cuda.is_available() is
     False.
  2. Build: compiles the hand-written CUDA kernels from csrc/ (sm_90a).
  3. Kernel parity, each kernel against its plain PyTorch version on the
     card within rtol 2e-4 / atol 2e-5, and its time beside the plain
     version's at the main path's shapes:
       K1 (near field) and K2 (octet far field) at the lists of the N = 1M
       operating point (examples/barneshut_1m_reuse.json) and in full at
       N = 65536, for both potential settings;
       K3 (all-pairs) in full at N = 262144 (examples/allpairs_262k.json)
       and at N = 65536, on 4096 sampled targets with the potential, and
       at an odd N = 1000;
       K4 (gather far field) at the N = 1M gather lists (upper and leaf
       list), in full at N = 65536, and on a scattered (front_packed=False)
       list.
  4. Octet main path: Simulation(cfg, device="cuda") on the N = 1M config,
     then step(1) (per step) and step(16) (two rebuild blocks of 8).
  5. All-pairs path: examples/allpairs_262k.json, step(1) and step(16);
     then SimConfig() as it stands (N = 4096, force="auto"), step(10).
  6. Gather path: the N = 1M config with bh_far_mode="gather", step(1) and
     step(8), and its forces against the octet path's on the same state.
  7. Crossover (printed, no gate): ms/step of force="direct_pallas"
     against per-step Barnes-Hut at N = 16384 to 262144.

Before each path every launch count is set to 0 and after it the counts
are read: each kernel of the path must have been launched, the list
overflow must be 0, every output finite, and the sampled rms force error
against the direct sum below the path's bound. ms/step comes from CUDA
events after a warm-up.

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
from parallelnbody_tpu_torch.ops import bh, bh_kernels, direct_kernels
from parallelnbody_tpu_torch.utils.accuracy import rms_force_error_sample

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "barneshut_1m_reuse.json")
ALLPAIRS_CONFIG = os.path.join(ROOT, "examples", "allpairs_262k.json")
RTOL, ATOL = 2e-4, 2e-5     # the Pallas-vs-jnp kernel bound of tests/test_bh.py
RMS_BOUND = 2e-3            # the accuracy class of the N=1M operating point
RMS_BOUND_ALLPAIRS = 1e-4   # all-pairs is exact: f32 rounding only
GATHER_OCTET_BOUND = 1e-5   # relative force norm, tests/test_bh.py:752
RMS_SAMPLES = 4096
SAMPLE_ROWS = 64            # target leaves of the 1M lists held with the potential
PARITY_N = 65536            # second, full-size parity point
ALLPAIRS_SAMPLE = 4096      # K3 targets held with the potential at N=262144
ODD_N = 1000                # K3 at an N that is no multiple of its tile
KERNEL_REPS = 10
STEP_REPS = 3
REUSE_STEPS = 16
GATHER_STEPS = 8
DEFAULT_STEPS = 10
CROSSOVER_N = (16384, 32768, 65536, 131072, 262144)
DEVICE = "cuda"

KERNELS = {
    "near_field": ("parallelnbody_tpu_torch/csrc/near_field.cu",
                   "parallelnbody_tpu/ops/pallas_bh.py:179"),
    "far_octet": ("parallelnbody_tpu_torch/csrc/far_octet.cu",
                  "parallelnbody_tpu/ops/pallas_bh.py:382"),
    "allpairs": ("parallelnbody_tpu_torch/csrc/allpairs.cu",
                 "parallelnbody_tpu/ops/pallas_direct.py:38"),
    "far_gather": ("parallelnbody_tpu_torch/csrc/far_gather.cu",
                   "parallelnbody_tpu/ops/pallas_bh.py:41"),
}


def reset_launch_counts():
    bh_kernels.reset_launch_counts()
    direct_kernels.reset_launch_counts()


def launch_counts():
    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}


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


def phase_allpairs_parity(cfg_json):
    """K3 against allpairs_plain: in full at N = 262144 (timed) and 65536,
    on sampled targets with the potential, and at an odd N."""
    dev = torch.device(DEVICE)
    kernel, plain = direct_kernels.allpairs, direct_kernels.allpairs_plain
    cfg = SimConfig.from_json(cfg_json)
    kw = dict(softening=cfg.softening)
    rec = {"max_abs_err": 0.0}

    def held(label, n, compute_pot, rows=None):
        state = init_simulation(cfg.replace(n=n), dev, compute_forces=False)
        tgt = state.pos if rows is None else state.pos[rows(n)].contiguous()
        args = (tgt, state.pos, state.mass)
        err = max_err(f"allpairs {label}",
                      (kernel(*args, compute_pot=compute_pot, **kw),),
                      (plain(*args, compute_pot=compute_pot, **kw),))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"allpairs {label} (compute_pot={compute_pot}): max abs err "
            f"{err:.3e}")

    # The main path's setting (track_potential=False) at its shape, timed.
    state = init_simulation(cfg, dev, compute_forces=False)
    full = (state.pos, state.pos, state.mass)
    got = kernel(*full, compute_pot=False, **kw)
    plain(state.pos[:ALLPAIRS_SAMPLE], state.pos, state.mass,
          compute_pot=False, **kw)                           # warm-up
    want, rec["plain_ms"] = cuda_ms(lambda: plain(*full, compute_pot=False,
                                                  **kw))
    rec["max_abs_err"] = max_err(f"allpairs N={cfg.n} full", (got,), (want,))
    del want
    kernel(*full, compute_pot=False, **kw)                   # warm-up
    _, rec["ms"] = cuda_ms(lambda: kernel(*full, compute_pot=False, **kw),
                           KERNEL_REPS)
    log(f"allpairs at N={cfg.n} (compute_pot=False): kernel {rec['ms']:.3f} "
        f"ms, plain {rec['plain_ms']:.1f} ms; full max abs err "
        f"{rec['max_abs_err']:.3e}")
    del state, full

    def sample(n):
        return torch.linspace(0, n - 1, ALLPAIRS_SAMPLE, device=dev).long()

    held(f"N={cfg.n}, {ALLPAIRS_SAMPLE} sampled targets", cfg.n, True, sample)
    for compute_pot in (True, False):
        held(f"N={PARITY_N} full", PARITY_N, compute_pot)
        held(f"N={ODD_N} full", ODD_N, compute_pot)
    return rec


def gather_lists_for(cfg, state):
    """The dense gather lists of the per-step path for cfg (calibrated
    budgets) at state: target leaves and the (table, idx, valid) of the
    upper and the leaf far class."""
    leaf = cfg.resolve_bh_leaf_size()
    pos_s, _, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    n_leaves = n_pad // leaf
    far, rej = bh.traverse(tree, cfg.theta)
    _, _, f0i, f0v, upi, upv, nodes_up, leaf_nodes, of = \
        bh.build_interaction_lists(
            tree, far, rej, theta=cfg.theta, start_leaf=0, n_slice=n_leaves,
            near_budget=cfg.resolve_bh_near_budget(),
            far0_budget=cfg.resolve_bh_far_budget(), dtype=torch.float32)
    if int(of) != 0:
        raise AssertionError(f"list overflow {int(of)} at calibrated budgets")
    return (pos_s.reshape(n_leaves, leaf, 3),
            [("upper", nodes_up, upi, upv), ("leaf", leaf_nodes, f0i, f0v)])


def phase_gather_parity(cfg_json):
    """K4 against far_gather_plain on the N = 1M gather lists (timed), in
    full at N = 65536, and on a scattered list."""
    dev = torch.device(DEVICE)
    kernel, plain = bh_kernels.far_gather, bh_kernels.far_gather_plain
    rec = {"max_abs_err": 0.0}
    cfg = SimConfig.from_json(cfg_json).replace(bh_far_mode="gather")
    kw = dict(g=cfg.g, softening=cfg.softening)

    def held(label, tgt, classes, compute_pot, rows=None):
        for name, table, idx, valid in classes:
            args = ((tgt, table, idx, valid) if rows is None else
                    (tgt[rows].contiguous(), table, idx[rows].contiguous(),
                     valid[rows].contiguous()))
            err = max_err(f"far_gather {label} {name}",
                          kernel(*args, compute_pot=compute_pot, **kw),
                          plain(*args, compute_pot=compute_pot, **kw))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            log(f"far_gather {label}, {name} list (compute_pot="
                f"{compute_pot}): max abs err {err:.3e}")

    t0 = time.perf_counter()
    state = init_simulation(cfg, dev, compute_forces=False)
    cfg = calibrate_budgets(cfg, state)
    tgt, classes = gather_lists_for(cfg, state)
    torch.cuda.synchronize()
    log(f"N={cfg.n} gather lists: budgets near {cfg.bh_near_budget} far "
        f"{cfg.bh_far_budget}; " + "; ".join(
            f"{name} entries mean {float(v.sum(1).float().mean()):.1f} max "
            f"{int(v.sum(1).max())}" for name, _, _, v in classes)
        + f" ({time.perf_counter() - t0:.1f} s)")

    def both(fn):
        return [fn(tgt, table, idx, valid, compute_pot=False, **kw)
                for _, table, idx, valid in classes]

    got = both(kernel)
    _, table, idx, valid = classes[1]
    plain(tgt[:SAMPLE_ROWS], table, idx[:SAMPLE_ROWS], valid[:SAMPLE_ROWS],
          compute_pot=False, **kw)                           # warm-up
    want, rec["plain_ms"] = cuda_ms(lambda: both(plain))
    for (name, *_), g_out, w_out in zip(classes, got, want):
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err(
            f"far_gather N={cfg.n} full {name}", g_out, w_out))
    del want
    both(kernel)                                             # warm-up
    _, rec["ms"] = cuda_ms(lambda: both(kernel), KERNEL_REPS)
    log(f"far_gather at N={cfg.n}, upper + leaf list (compute_pot=False): "
        f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms; full "
        f"max abs err {rec['max_abs_err']:.3e}")
    rows = torch.linspace(0, tgt.shape[0] - 1, SAMPLE_ROWS, device=dev).long()
    held(f"N={cfg.n}, {SAMPLE_ROWS} sampled target leaves", tgt, classes,
         True, rows)
    del state, tgt, classes, got

    small = cfg.replace(n=PARITY_N, bh_near_budget=0, bh_far_budget=0)
    state = init_simulation(small, dev, compute_forces=False)
    tgt, classes = gather_lists_for(calibrate_budgets(small, state), state)
    for compute_pot in (True, False):
        held(f"N={PARITY_N} full", tgt, classes, compute_pot)

    # A scattered list (tests/test_bh.py:394): one valid source at node 600
    # of 700, past the kernel's first chunk of entries.
    gen = torch.Generator(device="cpu").manual_seed(3)
    tgt = (0.2 * torch.rand((1, 8, 3), generator=gen) - 0.1).to(dev)
    nodes = torch.zeros((700, 4), device=dev)
    nodes[600] = torch.tensor([2.0, 0.0, 0.0, 5.0], device=dev)
    idx = torch.arange(700, dtype=torch.int32, device=dev)[None].contiguous()
    valid = torch.zeros((1, 700), dtype=torch.bool, device=dev)
    valid[0, 600] = True
    sk = dict(g=1.0, softening=0.0)
    acc, pot = kernel(tgt, nodes, idx, valid, front_packed=False, **sk)
    err = max_err("far_gather scattered", (acc, pot),
                  plain(tgt, nodes, idx, valid, **sk))
    if not float(acc[:, 0].abs().min()) > 0.5:
        raise AssertionError("far_gather scattered: the valid source at "
                             "node 600 was skipped")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    log(f"far_gather scattered list (front_packed=False): max abs err "
        f"{err:.3e}")
    return rec


def check_state(label, state, n):
    for field in ("pos", "vel", "acc"):
        t = getattr(state, field)
        if tuple(t.shape) != (n, 3) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: {field} {tuple(t.shape)} not "
                                 "finite or of the wrong shape")


def drive_path(label, cfg, kernels, steps, rms_bound):
    """Simulation(cfg) on the card through step(k) for k in steps, with
    every launch count set to 0 just before and read just after. Fails
    unless each of `kernels` was launched, nothing overflowed, every state
    is finite and the sampled rms force error against the direct sum stays
    below rms_bound. Returns (sim, launches)."""
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = Simulation(cfg, device=DEVICE)
    torch.cuda.synchronize()
    times = [f"Simulation init {time.perf_counter() - t0:.2f} s"]
    states, done = [], 0
    for k in steps:
        t0 = time.perf_counter()
        states.append((f"step({k})", sim.step(k)))
        torch.cuda.synchronize()
        done += k
        times.append(f"first step({k}) {time.perf_counter() - t0:.2f} s")
    launches = launch_counts()
    overflow = int(sim.overflow)
    times.append("peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{label}: force {sim.cfg.resolve_force(DEVICE)}; " + "; ".join(times))
    log(f"{label}: launches {launches}; overflow {overflow}")

    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched")
    if overflow != 0:
        raise AssertionError(f"{label}: list overflow {overflow}")
    if int(sim.state.step) != done:
        raise AssertionError(f"{label}: step counter {int(sim.state.step)}")
    for step_label, state in states:
        check_state(f"{label} {step_label}", state, cfg.n)
        rms = rms_force_error_sample(state.pos, state.mass, state.acc,
                                     g=cfg.g, softening=cfg.softening,
                                     k=RMS_SAMPLES)
        log(f"{label}: rms force error vs direct sum after {step_label} "
            f"(k={min(RMS_SAMPLES, cfg.n)}): {rms:.4e}")
        if not rms < rms_bound:
            raise AssertionError(f"{label} {step_label}: rms {rms:.4e} >= "
                                 f"{rms_bound}")
    return sim, launches


def report_diagnostics(label, sim):
    diag = sim.diagnostics()
    log(f"{label}: diagnostics " + json.dumps(diag))
    if not all(math.isfinite(v) for v in diag.values()):
        raise AssertionError(f"{label}: non-finite diagnostics")


def phase_octet_path(cfg_json):
    cfg = SimConfig.from_json(cfg_json)
    sim, launches = drive_path("octet path", cfg, ("near_field", "far_octet"),
                               (1, REUSE_STEPS), RMS_BOUND)
    _, ms_step = cuda_ms(lambda: sim.step(1), STEP_REPS)
    _, ms_block = cuda_ms(lambda: sim.step(REUSE_STEPS))
    log(f"octet path: ms/step at N={cfg.n}: per-step {ms_step:.2f} (mean of "
        f"{STEP_REPS} step(1)), rebuild every {cfg.bh_rebuild_every} "
        f"{ms_block / REUSE_STEPS:.2f} (step({REUSE_STEPS}))")
    report_diagnostics("octet path", sim)
    return launches


def phase_allpairs_path(cfg_json):
    cfg = SimConfig.from_json(cfg_json)
    sim, launches = drive_path("all-pairs path", cfg, ("allpairs",),
                               (1, REUSE_STEPS), RMS_BOUND_ALLPAIRS)
    _, ms_step = cuda_ms(lambda: sim.step(1), STEP_REPS)
    log(f"all-pairs path: ms/step at N={cfg.n}: {ms_step:.2f} (mean of "
        f"{STEP_REPS} step(1))")
    report_diagnostics("all-pairs path", sim)
    del sim

    default = SimConfig()
    if default.resolve_force(DEVICE) != "direct_pallas":
        raise AssertionError("SimConfig() does not resolve to direct_pallas "
                             f"on {DEVICE}")
    drive_path("default SimConfig()", default, ("allpairs",),
               (DEFAULT_STEPS,), RMS_BOUND_ALLPAIRS)
    return launches


def phase_gather_path(cfg_json):
    cfg = SimConfig.from_json(cfg_json).replace(bh_far_mode="gather")
    sim, launches = drive_path("gather path", cfg,
                               ("near_field", "far_gather"),
                               (1, GATHER_STEPS), RMS_BOUND)
    _, ms_step = cuda_ms(lambda: sim.step(1), STEP_REPS)
    log(f"gather path: ms/step at N={cfg.n}: {ms_step:.2f} (mean of "
        f"{STEP_REPS} step(1); gather rebuilds the lists every step)")
    report_diagnostics("gather path", sim)

    # The same state through both far modes (tests/test_bh.py:752).
    c, s = sim.cfg, sim.state
    kw = dict(leaf_size=c.resolve_bh_leaf_size(), theta=c.theta, g=c.g,
              softening=c.softening, near_budget=c.bh_near_budget,
              curve=c.bh_curve, multipole=c.bh_multipole,
              max_levels=c.bh_max_levels, compute_pot=False)
    ag, _, og = bh.bh_accel(s.pos, s.mass, far0_budget=c.bh_far_budget,
                            far_mode="gather", **kw)
    # An octet budget of n_leaves covers every octet: nothing can clip.
    n_leaves = bh.plan_tree(c.n, kw["leaf_size"], c.bh_max_levels)[0]
    ao, _, oo = bh.bh_accel(s.pos, s.mass, far0_budget=n_leaves,
                            far_mode="octet", **kw)
    rel = float(torch.linalg.norm(ag - ao) / torch.linalg.norm(ag))
    log(f"gather path: forces against the octet path on the same state: "
        f"relative norm {rel:.3e}; overflow {int(og)} / {int(oo)}")
    if int(og) != 0 or int(oo) != 0 or not rel < GATHER_OCTET_BOUND:
        raise AssertionError(f"gather vs octet: relative norm {rel:.3e} "
                             f"(bound {GATHER_OCTET_BOUND}), overflow "
                             f"{int(og)} / {int(oo)}")
    return launches


def phase_crossover():
    """ms/step of force="direct_pallas" against per-step Barnes-Hut
    (theta 0.72, quadrupole), Plummer, track_potential=False. No gate."""
    for n in CROSSOVER_N:
        row = {"n": n}
        for force in ("direct_pallas", "barnes_hut"):
            cfg = SimConfig(n=n, ic="plummer", softening=0.01, theta=0.72,
                            bh_multipole=2, force=force,
                            track_potential=False, bh_rebuild_every=1)
            sim = Simulation(cfg, device=DEVICE)
            sim.step(1)                                      # warm-up
            _, row[force] = cuda_ms(lambda: sim.step(1), STEP_REPS)
            del sim
        row["faster"] = min(("direct_pallas", "barnes_hut"), key=row.get)
        log("crossover " + json.dumps(row))


def main():
    smi = phase_environment()
    with open(CONFIG) as f:
        cfg_json = f.read()
    with open(ALLPAIRS_CONFIG) as f:
        allpairs_json = f.read()
    phase_build()
    kernels = phase_kernel_parity(cfg_json)
    kernels["allpairs"] = phase_allpairs_parity(allpairs_json)
    kernels["far_gather"] = phase_gather_parity(cfg_json)
    # Each kernel's launches are read from the path that carries it.
    launches = phase_octet_path(cfg_json)
    launches["allpairs"] = phase_allpairs_path(allpairs_json)["allpairs"]
    launches["far_gather"] = phase_gather_path(cfg_json)["far_gather"]
    phase_crossover()

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
