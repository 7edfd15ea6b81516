#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parallelnbody_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. Environment: torch, CUDA and nvcc versions, the card's name, power
     limit and SM clocks. Exits with an error when
     torch.cuda.is_available() is False.
  2. Build: compiles the hand-written CUDA kernels from csrc/ (sm_90a),
     and counts the instructions a pair of each kernel's inner loop on the
     main path (tools/sass.py, cuobjdump).
  3. Kernel parity, each kernel against its plain PyTorch version on the
     card within rtol 2e-4 / atol 2e-5, and its time beside the plain
     version's at the main path's shapes:
       K1 (near field) and K2 (octet far field) at the lists of the N = 1M
       operating point (examples/barneshut_1m_reuse.json) and in full at
       N = 65536, for both potential settings; K1 also, timed, on the lists
       of the state after 8 steps of the octet path, and, timed, in full at
       N = 262144 with the auto leaf size 128 (both potential settings);
       K3 (all-pairs) in full at N = 262144 (examples/allpairs_262k.json)
       and at N = 65536, on 4096 sampled targets with the potential, and
       at an odd N = 1000;
       K1 and K3 launched twice on the same inputs give the same bits;
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

Each kernel's bound is the least time the card could take for the work of
this run's inputs: the larger of its FP32 operations over 67 TFLOP/s, its
rsqrts over the MUFU rate (16 a clock per SM, 1/16 of the FP32 rate) and
the bytes of its inputs and outputs, each moved once, over 3.35 TB/s (the
H100 SXM's published rates at 700 W). A monopole pair term without the
potential is 18 FP32 operations (an FMA as two) and one rsqrt, which the
MUFU term counts; a quadrupole term 57 and one rsqrt. share = bound / time.
K1 is timed on work items built beforehand, as the paths build them once
per list build; the items' own cost is timed apart.

The last four lines of standard output are one JSON object with the
kernels' numbers, the card's SM clock and its maximum as nvidia-smi gives
them (sampled while K1's timed launches run), the card's nvidia-smi name
and power limit, and {"ok": true, "device": {...}}.
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
from parallelnbody_tpu_torch.tools import sass
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
LEAF128_N = 262144          # K1/K2 parity and K1 time at the auto leaf 128
ALLPAIRS_SAMPLE = 4096      # K3 targets held with the potential at N=262144
ODD_N = 1000                # K3 at an N that is no multiple of its tile
KERNEL_REPS = 10
LATER_STEPS = 8             # K1 is timed again on the lists after this many
STEP_REPS = 3
REUSE_STEPS = 16
GATHER_STEPS = 8
DEFAULT_STEPS = 10
CROSSOVER_N = (16384, 32768, 65536, 131072, 262144)
DEVICE = "cuda"

FP32_FLOPS = 67e12          # H100 SXM, FP32 outside the tensor cores, 700 W
MUFU_RATE = FP32_FLOPS / 16  # rsqrt/s: 16 a clock per SM against 256 FP32 flops
HBM_BYTES = 3.35e12         # B/s
FLOPS_MONOPOLE = 18         # d 3, r^2 6, w 3, sums 6 (terms.cuh); + 1 rsqrt
FLOPS_QUADRUPOLE = 57       # + 39 for the traceless quadrupole (node_term)

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
# Each kernel's instantiation on the main path (compute_pot=False, softened;
# K1 at leaf 256, K2/K4 with quadrupoles), as its mangled name spells it.
MAIN_INSTANCE = {
    "near_field": "near_field_kernelILi8ELb0ELb0E",
    "far_octet": "far_octet_kernelILb1ELb0ELb0E",
    "allpairs": "allpairs_kernelILb0ELb0E",
    "far_gather": "far_gather_kernelILb1ELb0ELb0ELb0E",
}


def reset_launch_counts():
    bh_kernels.reset_launch_counts()
    direct_kernels.reset_launch_counts()


def launch_counts():
    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES}


def log(msg=""):
    print(msg, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(terms, flops_per_term, n_bytes):
    """The least time for `terms` interaction terms of flops_per_term FP32
    operations and one rsqrt each, moving n_bytes: bound_ms, bound_by
    ("operations" or "bytes") and the resource ("fp32", "mufu", "hbm")."""
    secs = {"fp32": terms * flops_per_term / FP32_FLOPS,
            "mufu": terms / MUFU_RATE, "hbm": n_bytes / HBM_BYTES}
    res = max(secs, key=secs.get)
    return {"bound_ms": secs[res] * 1e3,
            "bound_by": "bytes" if res == "hbm" else "operations",
            "bound_resource": res}


def with_share(rec, work):
    """rec updated with the bound of `work` (bound()'s result) and the
    share bound / time."""
    rec.update(work)
    rec["share"] = rec["bound_ms"] / rec["ms"]
    return rec


def repeat_equal(name, fn):
    """Two launches of fn() on the same inputs must give the same bits."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             "differ")
    return True


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
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; SM clock, "
        f"max: {clocks()}")
    # Plain versions run einsum through matmul: keep it in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def clocks():
    return run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                "--format=csv,noheader"]).splitlines()[0]


def phase_build():
    """Build and load the kernels; returns {kernel: SASS instructions a pair
    of its main-path inner loop}."""
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"  {line.strip()}")
    loops, usage = sass.inner_loops(lib), sass.ptxas_usage(lib)
    per_pair = {}
    for name, instance in MAIN_INSTANCE.items():
        found = [m for m in loops if instance in m]
        if len(found) != 1:
            raise AssertionError(f"{name}: {len(found)} kernels match "
                                 f"{instance} in the SASS")
        rec = loops[found[0]]
        per_pair[name] = rec["per_pair"]
        regs, smem = usage.get(found[0], (None, None))
        log(f"SASS {name} ({instance}): inner loop {rec['instructions']} "
            f"instructions, {rec['pairs']} MUFU.RSQ, {rec['per_pair']:.3f} a "
            f"pair; {regs} registers, {smem} bytes static shared; "
            f"{json.dumps(rec['opcodes'])}")
    return per_pair


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


def clocks_under_load(fn, reps=KERNEL_REPS):
    """The SM clock and its maximum, sampled by nvidia-smi while reps
    launches of fn(), queued beforehand, keep the card busy."""
    for _ in range(reps):
        fn()
    sample = clocks()
    torch.cuda.synchronize()
    return sample


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
                fv=fv, nodes8=nodes8, work=bh_kernels.near_work(nv))


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


def list_work(name, L, n_comp=None):
    """bound() of one call of K1 (name "near_field") or K2 on the lists L
    with compute_pot=False: K1 sums cnt x G^2 pair terms a row, K2 G
    node-target terms for each accepted child of each listed octet."""
    tgt = L["tgt"]
    n_slice, leaf, _ = tgt.shape
    out_bytes = n_slice * leaf * 16                       # acc + pot
    if name == "near_field":
        terms = int(L["nv"].sum()) * leaf * leaf
        return bound(terms, FLOPS_MONOPOLE, out_bytes + nbytes(
            L["pos_s"], L["mass_s"], tgt, L["ni"], L["nv"]))
    mask = torch.where(L["fv"], L["fk"] & 0xFF, 0)
    children = sum(int(((mask >> b) & 1).sum()) for b in range(8))
    flops = FLOPS_QUADRUPOLE if L["nodes8"].shape[1] >= 9 else FLOPS_MONOPOLE
    return bound(children * leaf, flops, out_bytes + nbytes(
        tgt, L["nodes8"], L["fk"], L["fv"]))


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
        # The main path's setting (track_potential=False) at its shapes; K1
        # on the items the path builds with the lists.
        full = args(L)
        fkw = dict(kw, work=L["work"]) if name == "near_field" else kw
        got = kernel(*full, compute_pot=False, **fkw)
        plain(*args(L, rows), compute_pot=False, **kw)      # warm-up
        want, rec["plain_ms"] = cuda_ms(
            lambda: plain(*full, compute_pot=False, **kw))
        err = max_err(f"{name} N={cfg.n} full", got, want)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del want
        kernel(*full, compute_pot=False, **fkw)              # warm-up
        _, rec["ms"] = cuda_ms(lambda: kernel(*full, compute_pot=False,
                                              **fkw), KERNEL_REPS)
        with_share(rec, list_work(name, L))
        log(f"{name} at N={cfg.n} (compute_pot=False): kernel "
            f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_resource']}), share "
            f"{rec['share']:.3f}; full max abs err {rec['max_abs_err']:.3e}")
        # With the potential, on a sample of target leaves.
        sub = args(L, rows)
        err = max_err(f"{name} N={cfg.n} {SAMPLE_ROWS} rows pot",
                      kernel(*sub, compute_pot=True, **kw),
                      plain(*sub, compute_pot=True, **kw))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"{name} at N={cfg.n}, {SAMPLE_ROWS} sampled target leaves "
            f"(compute_pot=True): max abs err {err:.3e}")
    rec = out["near_field"]
    rec["clocks"] = clocks_under_load(lambda: bh_kernels.near_field(
        *near_args(L), compute_pot=False, work=L["work"], **kw))
    rec["pair_terms"] = int(L["nv"].sum()) * L["tgt"].shape[1] ** 2
    rec["deterministic"] = repeat_equal(
        "near_field", lambda: bh_kernels.near_field(
            *near_args(L), compute_pot=False, **kw))
    # The work items' own cost, host wait included: once per list build.
    bh_kernels.near_work(L["nv"])                            # warm-up
    _, rec["work_ms"] = cuda_ms(lambda: bh_kernels.near_work(L["nv"]),
                                KERNEL_REPS)
    log(f"near_field work items at N={cfg.n}: "
        f"{L['work'].items.shape[0]} items, {L['work'].splits.shape[0]} "
        f"split rows, {L['work'].n_partial} partial slots; built in "
        f"{rec['work_ms']:.3f} ms (host wait included); SM clock, max while "
        f"K1 runs: {rec['clocks']}")
    del L, state

    # K1 again on the lists of the state after LATER_STEPS octet steps,
    # where the t = 0 lists' longest rows have relaxed.
    sim = Simulation(cfg, device=DEVICE)
    sim.step(LATER_STEPS)
    L = lists_for(sim.cfg, sim.state)
    del sim
    full = near_args(L)
    got = bh_kernels.near_field(*full, compute_pot=False, **kw)
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(
        f"near_field N={cfg.n} after {LATER_STEPS} steps", got,
        bh_kernels.near_field_plain(*full, compute_pot=False, **kw)))
    _, ms = cuda_ms(lambda: bh_kernels.near_field(
        *full, compute_pot=False, work=L["work"], **kw), KERNEL_REPS)
    later = with_share({"ms": ms}, list_work("near_field", L))
    pairs = int(L["nv"].sum()) * L["tgt"].shape[1] ** 2
    rec.update({f"{k}_step{LATER_STEPS}": later[k]
                for k in ("ms", "bound_ms", "share")},
               **{f"pair_terms_step{LATER_STEPS}": pairs})
    per_pair = [rec["ms"] / rec["pair_terms"], ms / pairs]
    rec["per_pair_ratio"] = max(per_pair) / min(per_pair)
    log(f"near_field on the lists after {LATER_STEPS} steps: near entries "
        f"mean {float(L['nv'].sum(1).float().mean()):.1f} max "
        f"{int(L['nv'].sum(1).max())}; {pairs:.4e} pair terms (t = 0: "
        f"{rec['pair_terms']:.4e}); kernel {ms:.3f} ms, bound "
        f"{later['bound_ms']:.3f} ms, share {later['share']:.3f}; time per "
        f"pair term {per_pair[1] * 1e9:.4f} ps against {per_pair[0] * 1e9:.4f}"
        f" ps at t = 0 (ratio {rec['per_pair_ratio']:.3f}); repeat launches "
        "bit-equal")
    del L, full, got

    # Full parity at two more sizes, both potential settings: N = 65536 at
    # leaf 256, and N = 262144 at its auto leaf size 128 (K1 then holds 4
    # targets a thread), where K1 is timed too.
    for n, leaf in ((PARITY_N, None), (LEAF128_N, 0)):
        small = SimConfig.from_json(cfg_json).replace(n=n)
        if leaf is not None:
            small = small.replace(bh_leaf_size=leaf)
        state = init_simulation(small, dev, compute_forces=False)
        small = calibrate_budgets(small, state)
        L = lists_for(small, state)
        label = f"N={n}, leaf {small.resolve_bh_leaf_size()}"
        for name, (kernel, plain, args) in funcs.items():
            for compute_pot in (True, False):
                err = max_err(f"{name} {label} pot={compute_pot}",
                              kernel(*args(L), compute_pot=compute_pot, **kw),
                              plain(*args(L), compute_pot=compute_pot, **kw))
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
                log(f"{name} at {label} (compute_pot={compute_pot}): max abs "
                    f"err {err:.3e}")
        if leaf is None:
            continue
        full = near_args(L)
        bh_kernels.near_field(*full, compute_pot=False, work=L["work"], **kw)
        _, ms = cuda_ms(lambda: bh_kernels.near_field(
            *full, compute_pot=False, work=L["work"], **kw), KERNEL_REPS)
        at = with_share({"ms": ms}, list_work("near_field", L))
        out["near_field"].update({f"{k}_leaf128": at[k]
                                  for k in ("ms", "bound_ms", "share")})
        log(f"near_field at {label} (compute_pot=False): kernel {ms:.3f} ms, "
            f"bound {at['bound_ms']:.3f} ms, share {at['share']:.3f}; "
            f"near entries mean {float(L['nv'].sum(1).float().mean()):.1f} "
            f"max {int(L['nv'].sum(1).max())}")
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
    rec["clocks"] = clocks_under_load(
        lambda: kernel(*full, compute_pot=False, **kw))
    with_share(rec, bound(cfg.n * cfg.n, FLOPS_MONOPOLE,
                          nbytes(*full) + cfg.n * 16))
    rec["deterministic"] = repeat_equal(
        "allpairs", lambda: (kernel(*full, compute_pot=False, **kw),))
    log(f"allpairs at N={cfg.n} (compute_pot=False): kernel {rec['ms']:.3f} "
        f"ms, plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.3f} ms "
        f"({rec['bound_resource']}), share {rec['share']:.3f}; full max abs "
        f"err {rec['max_abs_err']:.3e}; repeat launches bit-equal; SM clock, "
        f"max while K3 runs: {rec['clocks']}")
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
    leaf = tgt.shape[1]
    terms = sum(int(v.sum()) * leaf for *_, v in classes)
    flops = FLOPS_QUADRUPOLE if classes[0][1].shape[1] >= 9 else FLOPS_MONOPOLE
    with_share(rec, bound(terms, flops, sum(
        nbytes(tgt, table, idx, valid) + tgt.shape[0] * leaf * 16
        for _, table, idx, valid in classes)))
    log(f"far_gather at N={cfg.n}, upper + leaf list (compute_pot=False): "
        f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_resource']}), share "
        f"{rec['share']:.3f}; full max abs err {rec['max_abs_err']:.3e}")
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
    per_pair = phase_build()
    kernels = phase_kernel_parity(cfg_json)
    kernels["allpairs"] = phase_allpairs_parity(allpairs_json)
    kernels["far_gather"] = phase_gather_parity(cfg_json)
    for name, value in per_pair.items():
        kernels[name]["sass_per_pair"] = value
    # Each kernel's launches are read from the path that carries it.
    launches = phase_octet_path(cfg_json)
    launches["allpairs"] = phase_allpairs_path(allpairs_json)["allpairs"]
    launches["far_gather"] = phase_gather_path(cfg_json)["far_gather"]
    phase_crossover()

    # No single PyTorch call computes any of the four functions.
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernels[name], "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(line))
    print(kernels["near_field"]["clocks"])
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
