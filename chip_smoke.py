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
       N = 65536, for both potential settings; both also, timed, on the
       lists of the state after 8 steps of the octet path (K2 with the
       accepted children per target leaf, mean and max, on both list
       sets), and in full at N = 262144 with the auto leaf size 128 (both
       potential settings; K1 and K2 timed);
       K3 (all-pairs) in full at N = 262144 (examples/allpairs_262k.json)
       and at N = 65536, on 4096 sampled targets with the potential, and
       at an odd N = 1000; its self-gravity form (allpairs_self) timed
       beside the cross form at N = 262144, 65536 and the points of the
       N_SYM sweep (N_SYM lowered so that it runs at each), each held to
       the plain version on sampled targets;
       K4 (gather far field) at the N = 1M gather lists (upper and leaf
       list), in full at N = 65536 and at N = 262144 with leaf 128, and on
       a scattered (front_packed=False) list;
       each of the four launched twice on the same inputs gives the same
       bits;
       K5-K7 (the tensor-core all-pairs kernels of tools/mxu_allpairs.py)
       at both precisions in full at N = 16384 (Hilbert-sorted Plummer)
       and, V3 and V1, at N = 1000, launched twice for the same bits, and
       at 3xTF32 at N = 262144, timed beside their plain versions; then the
       tool's table (V0 = K3, V3, V1, V4 at one TF32 pass and 3xTF32: rms
       against the f64 direct sum at N = 16384, ms, bound, share and the
       MUFU floor at N = 262144), V4 at 3xTF32 below rms 1e-4.
  4. Octet main path: Simulation(cfg, device="cuda") on the N = 1M config,
     then step(1) (per step) and step(16) (two rebuild blocks of 8).
  5. All-pairs path: examples/allpairs_262k.json, step(1) and step(16);
     then SimConfig() as it stands (N = 4096, force="auto"), step(10).
  6. Gather path: the N = 1M config with bh_far_mode="gather", step(1) and
     step(8), and its forces against the octet path's on the same state.
  7. Crossover: ms/step of force="direct_pallas" against per-step
     Barnes-Hut at N = 16384 to 262144 (163840, 196608 and 229376 in the
     gap where they cross), each the median of 3 means of 5 step(1);
     fails where force="auto" picks, by the card's crossover, a path more
     than 1.5x slower than the other.
  8. Staged kernel parity on the t = 0 lists of examples/barneshut_8m.json
     (staged refinement, 32768 leaves of 256): K1 on the staged near
     lists, K2 on the staged octet keys, K4 on the one staged gather list,
     each timed in full with its bound and against its plain version on
     sampled target leaves with and without the potential; K2 on a row
     naming one octet in keys with disjoint masks; K1's items and K2's
     accepted children per leaf; the work items' and launch orders' own
     build time.
  9. Staged path: examples/barneshut_8m.json through Simulation, step(1)
     and step(16), with its calibrated budgets; then with
     bh_far_mode="gather", step(1), its forces against the octet path's.
 10. Galaxy path: examples/galaxy_2m.json (galaxy_collision ICs, auto
     leaf, staged, potential on), step(1) and step(8); then ms/step of
     step(1) and step(16).
 11. Command line (cli.main in this process), on examples/galaxy_2m.json
     as shipped with --steps and the output directories (under build/)
     overridden: `run` for 64 steps with snapshots and metrics every 16 and
     checkpoints every 32, `run --resume` to step 96, bit for bit equal to
     an uninterrupted 96-step run at the same cadences, the final state's
     rms force error; `render --show-tree` on the trajectory (box pixels
     present); `tree` at the run's calibrated budgets (overflow 0, peak
     memory within 1.5x of the galaxy path's); `bench` per step and with
     --run-steps 16, within 1.3x of the galaxy path's Simulation times;
     `oracle` at the two Barnes-Hut drift gates of tests/test_oracle.py
     (drift < 1e-6, rebuild every 1 and every 8); `python -m
     parallelnbody_tpu_torch info` in a subprocess. K1 and K2 must be
     launched by every command that evaluates forces.
 12. Sections: at N = 8M, bh_accel and one rebuild-8 block in 4 windows
     against one, bit for bit; then examples/barneshut_32m.json through
     Simulation and step(1) at its resolved sections, and in 8 windows
     where the auto resolves 1.
 13. Each IC family through Simulation at N = 65536, step(1);
     reference_compat_config() (the direct sum, softening 0), step(1); and
     a Barnes-Hut run with softening 0 (K1's guard_zero).
 14. K1's window and table forms (parallel/ ring and LET near fields) on
     the lists of rank 0 of examples/barneshut_distributed_let.json (N =
     4M, 8 ranks sharing the card, parallel/tasks.owned_geometry): the
     launch shape (targets a thread x entries an item) and item count each
     of the 8 ring windows picks from its work; the window form on each
     window, and the ring evaluation that writes the first window and adds
     the others in place, the table form on the assembled LET table and on
     that table cut to half its rows, both potential settings, against the
     plain versions; the ring timed in turns against 8-entry items that
     write and are added by torch, and the table form in the same run,
     each with its bound and launched twice for the same bits; the ring
     against the table form (< 1e-5). (Phase 3 adds: on the 1M lists the
     window form with leaf_lo = 0 over every leaf equals the unwindowed
     form bit for bit, and its time.)
 15. Both multi-device examples through cli.main, the ranks spawned by the
     CLI and sharing the card through gloo (tensors staged through host
     memory): examples/allpairs_4m_mesh.json as shipped on 4 ranks,
     --steps 1, K3 launched 4 times a rank an evaluation, 4096 sampled
     targets' forces against the f64 direct sum on the final state (< 1e-4,
     the all-pairs bound; single-device K3 on the same targets is printed
     beside it); examples/barneshut_distributed_let.json as shipped on 8
     ranks, --steps 2, then with bh_comm ring, ring with the gather far
     field (K4) for one step, bh_rebuild_every 8 over 8 steps, and
     bh_distributed false on 4 ranks (the replicated tree). Each: overflow
     0, rms < 2e-3 against the direct sum and within 1.5x + 1e-3 of the
     single-device bh_accel's on the same state, K1 launched on every rank
     in its form for each K2 (or K4) launch (window 8 times, table once,
     unwindowed once), wall ms/step, bytes staged and the backend. Only
     --steps, the checkpoint directory and cadence (and the variant's own
     flags) differ from the shipped configs.
 16. A one-rank group on the card (the nccl branch of the backend rule):
     one NCCL all_reduce and dist_bh_accel at N = 8192.
 17. K8-K11, the near-field experiments of scripts/near_kernel_probe.py
     and the three scripts/flat_kernel_*.py (ops/near_probe.py,
     ops/near_flat.py): every instantiation against its plain version and
     launched twice for the same bits, K8 on the N = 65536 leaf-256 lists
     (modes A, B, C, E x unroll 4, 8 x 4 or 8 floats a source, 4
     segments, each written or added over its work items, rows cut into
     several; A also in one), K9-K11 on those lists' flat form (4, 8, 16
     packs a step, both output modes, with and without the potential) and
     at the scripts' check sizes (within rtol 2e-4 of each target row's
     largest |value| plus atol 2e-5: random sources cancel some sums to
     near zero). Then the tools' tables with every launch count set to 0
     before and read after (tools/near_kernel_probe.py and
     tools/flat_kernel.py lists on the N = 1M lists, each row that computes
     K1's function held to K1; flat_kernel proto, tune, tune2 at the
     scripts' sizes, each bench launch held to its plain version on 32
     sampled rows; 3 timed calls each): each of K8-K11 must launch. Last,
     at N = 1M, each kernel's reported row and K8's modes B and C against
     their plain versions (elementwise rtol 2e-4 / atol 2e-5), which are
     timed.
 18. In a process of its own (this script with --geometry-tools FILE,
     run between phases 13 and 14; by then this process's profiler loses
     CUDA activity records), the per-phase Barnes-Hut tools, each with
     every launch count set to 0 before and read after, their JSON lines
     kept in
     build/chip_smoke_tools.jsonl: tools/bh_breakdown.py in the script's
     gather mode at N = 1M, in octet mode on examples/barneshut_1m_reuse.json
     (calibrated) with --rebuild 8, and on examples/barneshut_8m.json
     (staged, calibrated), each phase's events ms, busy ms and share and
     the per-step and rebuild-8 rows printed; tools/li_profile.py;
     tools/staged_probe.py --mode phases at 1M; tools/octet_probe.py
     --set 8m and --set probe --quick; tools/reuse_probe.py at 1M, --k 16;
     tools/theta_sweep.py. Fails where the composed phases differ from
     bh_accel beyond rtol 2e-4 / atol 2e-5, a calibrated run (the two
     --config breakdowns, reuse_probe's timed runs) overflows, a tool
     does not launch K1, K2, K4 or K3 where it runs them, or a busy
     reading is not whole (tools/measure.py busy_reading: its device
     records fewer than its launch calls, or other than one of each port
     kernel the wrappers counted) in 3 tries. First, the 1M octet path's
     per-step ms and busy share read afresh in that process.
 19. In a process of its own (this script with --port-tools FILE, run
     after phase 18), the benchmark suite and the probes ported last,
     each with every launch count set to 0 before and read after, their
     JSON lines in build/chip_smoke_port_tools.jsonl:
     tools/bench_suite.py's full list (all-pairs 65536 and 262144,
     Barnes-Hut 262144, 1M, the 2M galaxy collision, 4M and 8M, each per
     step and at rebuild 8; without --xl, the one cut, listed in the
     phase's JSON line), every row without error, K1 and K2 launched in
     each Barnes-Hut row and K3 in each all-pairs row, overflow 0 and rms
     below 2e-3 on the Barnes-Hut rows; tools/sections_probe.py at 16M
     in 1 and 4 windows, bit-equal forces; on 8 ranks sharing the card,
     tools/dist_collectives_probe.py (ring and LET, per step and at
     rebuild 8, budgets 320 / 1024: the counts by kind, the structural
     counts they recompose into, the JAX package's count for that
     structure),
     tools/dist_production_probe.py (N = 262144 at near budget 2560,
     overflow 0 and rms below 2e-3 for ring and LET, the migrant series)
     and
     tools/exchange_volume_probe.py (both cases, 120 steps, overflow 0),
     K1's window or table form and K2 launched on rank 0 of every run;
     tools/let_halo_probe.py and tools/let_granularity_probe.py. A busy
     reading that is not whole in 3 tries is printed as not measured.
 21. Budget heal (alone: this script with --budget-heal): the seven
     Plummer spheres of the benchmark's sampler at N = 1M on which budgets
     calibrated at t = 0 and one step on used to clip (HEAL_SEEDS),
     through Simulation with every budget auto, HEAL_CALLS calls of
     step(8) and of step(1): overflow 0 on every call and the state bit
     for bit that of the same calls at budgets of full width. One JSON
     line a seed and k: the list rebuilds (bh.heals) each call took (the
     rounds of its heal), the calibrated budgets, and the ms of the calls
     that healed beside the median call.
 22. K1's mutual form (also alone: this script with --k1-pairs, after the
     build): on the 1M lists and on the 8M staged lists at leaf 128 (the
     benchmark cell's) and 256, K1 on the mutual items the paths build
     (each mutual leaf pair once) and on the one-way items, each timed in
     alternating rounds against the FP32 bound of the pair terms served,
     held to each other in full and to the plain version on sampled
     target leaves, launched twice for the same bits; the share of the
     entries in mutual pairs, the partial slots and both work items'
     build time. One JSON line.

Before each path every launch count is set to 0 and after it the counts
are read (for a multi-device run, each rank's own counts, from
parallel/mesh.py LAST_RANK_STATS): each kernel of the path must have been
launched, the list
overflow must be 0, every output finite, and the sampled rms force error
against the direct sum below the path's bound. ms/step comes from CUDA
events after a warm-up; the device's busy time in one more step (or
rebuild block) from torch.profiler's CUDA activity, whose share of the
step says how far the host holds the card back.

Each kernel's bound is the least time the card could take for the work of
this run's inputs: the larger of its FP32 operations over 67 TFLOP/s, its
rsqrts over the MUFU rate (16 a clock per SM, 1/16 of the FP32 rate) and
the bytes of its inputs and outputs, each moved once, over 3.35 TB/s (the
H100 SXM's published rates at 700 W), and for K5-K7 also their
tensor-core FLOPs over 495 TFLOP/s (dense TF32). A monopole pair term
without the potential is 18 FP32 operations (an FMA as two) and one
rsqrt, which the MUFU term counts; a quadrupole term 48 (terms.cuh
quad_term) and one rsqrt, with the share against the former term's 57
printed beside.
share = bound / time.
K1 is timed on work items built beforehand, K2 and K4 on launch orders
built beforehand, as the paths build them once per list build; their own
cost is timed apart.

The script prints its wall time. The last four lines of standard output
are one JSON object with the kernels' numbers (the 8M staged lists' under
keys ending in _staged8m), the card's SM clock and its maximum as nvidia-smi gives
them (sampled while K1's timed launches run), the card's nvidia-smi name
and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from parallelnbody_tpu_torch import SimConfig, Simulation
from parallelnbody_tpu_torch.api import (calibrate_budgets, init_simulation,
                                         make_run)
from parallelnbody_tpu_torch.config import IC_KINDS, reference_compat_config
from parallelnbody_tpu_torch.kernels import build
from parallelnbody_tpu_torch.ops import (bh, bh_kernels, direct_kernels,
                                         direct_mma, near_flat, near_probe)
from parallelnbody_tpu_torch.parallel import RankPool
from parallelnbody_tpu_torch.tools import (aniso_bounds_probe,
                                           bench_suite, bh_breakdown,
                                           cell_leaves_probe,
                                           dist_collectives_probe,
                                           dist_production_probe,
                                           exchange_volume_probe,
                                           flat_kernel, let_granularity_probe,
                                           let_halo_probe, li_profile,
                                           mac_experiment, measure,
                                           multipole_order_probe,
                                           mxu_allpairs, near_kernel_probe,
                                           near_octet_stats,
                                           near_refine_probe, octet_probe,
                                           reuse_probe, sass, sections_probe,
                                           staged_probe, theta_sweep)
from parallelnbody_tpu_torch.utils.accuracy import (direct_accel_at,
                                                    rms_force_error_sample)

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "barneshut_1m_reuse.json")
ALLPAIRS_CONFIG = os.path.join(ROOT, "examples", "allpairs_262k.json")
STAGED_CONFIG = os.path.join(ROOT, "examples", "barneshut_8m.json")
GALAXY_CONFIG = os.path.join(ROOT, "examples", "galaxy_2m.json")
XL_CONFIG = os.path.join(ROOT, "examples", "barneshut_32m.json")
LET_CONFIG = os.path.join(ROOT, "examples", "barneshut_distributed_let.json")
MESH_CONFIG = os.path.join(ROOT, "examples", "allpairs_4m_mesh.json")
GATHER_FAR_BUDGET = 12288  # node rows a leaf for the ring gather run
RTOL, ATOL = 2e-4, 2e-5     # the Pallas-vs-jnp kernel bound of tests/test_bh.py
RMS_BOUND = 2e-3            # the accuracy class of the N=1M operating point
RMS_BOUND_ALLPAIRS = 1e-4   # all-pairs is exact: f32 rounding only
GATHER_OCTET_BOUND = 1e-5   # relative force norm, tests/test_bh.py:752
RMS_SAMPLES = 4096
SAMPLE_ROWS = 64            # target leaves of the 1M lists held with the potential
PARITY_N = 65536            # second, full-size parity point
LEAF128_N = 262144          # K1/K2/K4 parity and K1/K2 time at the auto leaf 128
ALLPAIRS_SAMPLE = 4096      # K3 targets held with the potential at N=262144
ODD_N = 1000                # K3 at an N that is no multiple of its tile
KERNEL_REPS = 10
LATER_STEPS = 8             # K1 and K2 are timed again on the lists after this many
STEP_REPS = 5
REUSE_STEPS = 16
GATHER_STEPS = 8
DEFAULT_STEPS = 10
CROSSOVER_N = (16384, 32768, 65536, 131072, 163840, 196608, 229376, 262144)
CROSSOVER_SLACK = 1.5       # auto's pick may be this much slower, no more
CROSSOVER_GROUPS = 3        # groups of STEP_REPS step(1) a sweep point; the
                            # median counts: per-step Barnes-Hut is
                            # host-bound, and the shared host's stalls come
                            # and go (11-24 ms a step within one run)
STAGED_SAMPLE_ROWS = 256    # target leaves of the 8M lists held with the plain versions
STAGED_STEP_REPS = 3
GALAXY_STEPS = 8
SECTIONS_8M = 4
XL_SECTIONS = 8             # explicit windows at 32M where the auto resolves 1
XL_RMS_SAMPLES = 2048       # the direct sum over 32M sources for each target
IC_N = 65536
CLI_STEPS = 64              # cli run, then --resume to CLI_RESUME_TO
CLI_RESUME_TO = 96
CLI_CADENCE = 16            # snapshots and metrics; checkpoints every 32, so
                            # segments of 16 = two rebuild blocks of 8 in both
                            # runs held against each other
TREE_PEAK_SLACK = 1.5       # tree's peak memory against the galaxy path's
BENCH_SLACK = 1.3           # cli bench against Simulation, same program
ORACLE_DRIFT = 1e-6         # tests/test_oracle.py:90,118
# The Barnes-Hut drift gates of tests/test_oracle.py:90,118 (1000 steps,
# N = 2048, theta 0.5, leaf 32, quadrupole); rebuild every 1 and every 8.
ORACLE_GATE = ["oracle", "--n", "2048", "--ic", "plummer", "--softening",
               "0.05", "--dt", "0.001", "--integrator", "leapfrog",
               "--force", "barnes_hut", "--theta", "0.5", "--bh-leaf-size",
               "32", "--bh-near-budget", "64", "--bh-far-budget", "256",
               "--bh-multipole", "2", "--dtype", "float32", "--steps", "1000"]
DEVICE = "cuda"

FP32_FLOPS = 67e12          # H100 SXM, FP32 outside the tensor cores, 700 W
MUFU_RATE = FP32_FLOPS / 16  # rsqrt/s: 16 a clock per SM against 256 FP32 flops
HBM_BYTES = 3.35e12         # B/s
FLOPS_MONOPOLE = 18         # d 3, r^2 6, w 3, sums 6 (terms.cuh); + 1 rsqrt
# FP32 operations of one mutual pair term, both ordered pairs (csrc/terms.cuh
# mutual_term: 3 FADD, 3 FFMA, 4 FMUL, 6 FFMA; an FMA as two).
FLOPS_MUTUAL = 25
# The quadrupole term K2 and K4 evaluate (terms.cuh quad_term): d 3, r^2 6,
# qd 15, qq 5, u^2 and u^5 3, m r^2 and qq u^2 2, the coefficient 2, the
# sums 12; + 1 rsqrt. The former term (Qzz and u^7 formed per target) took
# 57; shares against that count are printed beside ("share_57ops").
FLOPS_QUADRUPOLE = 48
FLOPS_QUADRUPOLE_OLD = 57
# K5-K7 (tools/mxu_allpairs.py FLOPS_PAIR, the same breakdown): V3 and V4
# off the band 12 (d 3, r^2 6, w 3; the sums on the tensor cores), V1 8
# (|x_i|^2 + |x_j|^2 1, -2 x_i.x_j 2, max 1, + eps^2 1, w 3), each + 1 for
# the split of w at 3xTF32; V4's band pairs 18. Their tensor-core FLOPs
# (W @ [x, y, z, 1] 8 a pair, V1's cross term 6 more, times the passes)
# over TF32_FLOPS, dense TF32.
TF32_FLOPS = 495e12
MMA_KERNELS = {"allpairs_mma_v3": "v3", "allpairs_mma_v1": "v1",
               "allpairs_mma_v4": "v4"}
MMA_PARITY_N = 16384        # K5-K7 in full against the plain versions
MMA_RMS_BOUND = RMS_BOUND_ALLPAIRS  # V4 at 3xTF32 (the others: printed)
# K8-K11, the near-field experiments (tools/near_kernel_probe.py,
# tools/flat_kernel.py): parity on the N = 65536 lists and at the scripts'
# check sizes, the tools' tables at their sizes with EXP_ITERS timed calls.
EXP_KERNELS = ("near_probe", "flat_near", "flat_tune", "flat_tune2")
EXP_PARITY_N = 65536
EXP_ITERS = 3
TOOL_ITERS = 3              # timed calls a phase in the geometry tools
TOOLS_LOG = os.path.join(ROOT, "build", "chip_smoke_tools.jsonl")
GEOMETRY_TOOLS_ARG = "--geometry-tools"   # phase 18 alone (a child process)
PORT_TOOLS_ARG = "--port-tools"           # phase 19 alone (a child process)
PORT_TOOLS_LOG = os.path.join(ROOT, "build", "chip_smoke_port_tools.jsonl")
PORT_TOOLS_BENCH = os.path.join(ROOT, "build", "chip_smoke_bench.md")
# Phase 19's sizes: each tool's defaults (the scripts') but these cuts,
# which the phase's JSON line lists; the uncut runs are the tools' own
# (README.md, PERF.md).
PORT_TOOLS_CUTS = ["bench_suite without --xl (16M and 32M)",
                   "dist_collectives_probe at budgets 320 / 1024 (the "
                   "script's 256 / 512 clip on the ranks; the counts do not "
                   "depend on them)"]
COLLECTIVES_BUDGETS = (320, 1024)
PORT_TOOLS_CUTS.append(
    "dist_production_probe at near budget 2560, the global leaf count (the "
    "script's 1024 clips the outermost leaves' near lists, up to ~2050 "
    "entries, on the port's ICs and on the JAX package's alike)")
PRODUCTION_BUDGETS = (2560, 2048)
DIST_RANKS = 8              # the scripts' rank count, sharing the card
COLLECTIVES_N = 8192        # dist_collectives_probe's N, 16 steps, k = 8
PRODUCTION_N = 262144       # dist_production_probe's N, 16 steps, k = 8
EXCHANGE_N = 16384          # exchange_volume_probe's N
EXCHANGE_STEPS = 120        # exchange_volume_probe's steps a case
STAT_TOOLS_ARG = "--stat-tools"           # phase 20 alone (a child process)
BUDGET_HEAL_ARG = "--budget-heal"         # phase 21 alone
K1_PAIRS_ARG = "--k1-pairs"               # phase 22 alone
# Phase 22's list sets: (label, config, leaf size (None: the config's),
# staged refinement), and the rounds of alternating timed forms.
K1_PAIR_LISTS = (("1M", CONFIG, None, False),
                 ("8M staged leaf 128", STAGED_CONFIG, 128, True),
                 ("8M staged leaf 256", STAGED_CONFIG, None, True))
K1_PAIR_ROUNDS = 2
# The benchmark's 1M spheres on which calibrated budgets clipped within a
# few calls before the step callables healed them (PERF.md §7.1), and the
# calls of step(k) each is driven through.
HEAL_SEEDS = (3000000104, 3000000402, 3000000501, 2147600002, 2147600005,
              2147600006, 2147600007)
HEAL_N = 1 << 20
HEAL_CALLS = {8: 4, 1: 24}
HEAL_FULL_WIDTH = {"bh_near_budget": 1 << 20, "bh_far_budget": 1 << 20,
                   "bh_cand2_budget": 1 << 20, "bh_cand_budget": 1 << 20}
STAT_TOOLS_LOG = os.path.join(ROOT, "build", "chip_smoke_stat_tools.jsonl")
# Phase 20 runs the six tools at their defaults (the scripts'), timed
# phases at STAT_ITERS calls; no other cut.
STAT_ITERS = 3
STAT_TOOLS_CUTS = [f"--iters {STAT_ITERS} (the tools' timed calls a "
                   "phase; the scripts timed nothing or 5 calls)"]
# The staged tree whose parent has more than 8 children: 4 ranks x 40
# leaves of 32 (levels 160 / 20 / 1), N = 4096, staged refinement forced,
# theta 0.72. Seed 4 of the Plummer ICs has targets that accept root
# children past the first octet (seeds 0-2 have none), so the repaired
# keys are evaluated.
WIDE_RANKS, WIDE_N, WIDE_LEAF, WIDE_SEED = 4, 4096, 32, 4
# Each kernel's row of the tools' tables reported as its time: the
# script's own first configuration, on K1's 1M lists.
EXP_HEADLINE = {"near_probe": "A dyn-idx u4", "flat_near": "P=4",
                "flat_tune": "P=4 rmw", "flat_tune2": "P=8 step"}

KERNELS = {
    "near_field": ("parallelnbody_tpu_torch/csrc/near_field.cu",
                   "parallelnbody_tpu/ops/pallas_bh.py:179"),
    # K1's window (leaf_lo=) and table (src_t4=) entry forms, the same
    # kernel with a leaf offset and items of each row's window run.
    "near_field_window": ("parallelnbody_tpu_torch/csrc/near_field.cu",
                          "parallelnbody_tpu/ops/pallas_bh.py:179"),
    "near_field_table": ("parallelnbody_tpu_torch/csrc/near_field.cu",
                         "parallelnbody_tpu/ops/pallas_bh.py:179"),
    "far_octet": ("parallelnbody_tpu_torch/csrc/far_octet.cu",
                  "parallelnbody_tpu/ops/pallas_bh.py:382"),
    "allpairs": ("parallelnbody_tpu_torch/csrc/allpairs.cu",
                 "parallelnbody_tpu/ops/pallas_direct.py:38"),
    "far_gather": ("parallelnbody_tpu_torch/csrc/far_gather.cu",
                   "parallelnbody_tpu/ops/pallas_bh.py:41"),
    # The matrix-unit all-pairs kernels of a TPU experiment, run by the
    # port's tools/mxu_allpairs.py (their launches are that tool's).
    "allpairs_mma_v3": ("parallelnbody_tpu_torch/csrc/allpairs_mma.cu",
                        "scripts/mxu_allpairs.py:41"),
    "allpairs_mma_v1": ("parallelnbody_tpu_torch/csrc/allpairs_mma.cu",
                        "scripts/mxu_allpairs.py:65"),
    "allpairs_mma_v4": ("parallelnbody_tpu_torch/csrc/allpairs_mma.cu",
                        "scripts/mxu_allpairs.py:86"),
    # The near-field experiments of four TPU scripts, run by the port's
    # tools/near_kernel_probe.py and tools/flat_kernel.py (their launches
    # are those tools' tables).
    "near_probe": ("parallelnbody_tpu_torch/csrc/near_probe.cu",
                   "scripts/near_kernel_probe.py:33"),
    "flat_near": ("parallelnbody_tpu_torch/csrc/near_flat.cu",
                  "scripts/flat_kernel_proto.py:32"),
    "flat_tune": ("parallelnbody_tpu_torch/csrc/near_flat.cu",
                  "scripts/flat_kernel_tune.py:28"),
    "flat_tune2": ("parallelnbody_tpu_torch/csrc/near_flat.cu",
                   "scripts/flat_kernel_tune2.py:28"),
}
# Each kernel's instantiation on the main path (compute_pot=False, softened;
# leaf 256: K1 with 8 targets a thread writing its output, K2 and K4 with 4
# and quadrupoles, K4 front-packed; K3 in its self-gravity form, whose
# instructions a pair are an unordered pair's, two ordered pairs), as its
# mangled name spells it (K3's two forms differ in their parameters).
MAIN_INSTANCE = {
    "near_field": "near_field_kernelILi8ELb0ELb0ELb0E",
    "far_octet": "far_octet_kernelILi4ELb1ELb0ELb0E",
    "allpairs": "allpairs_kernelILb0ELb0EEEvPKfS2_",
    "far_gather": "far_gather_kernelILi4ELb1ELb0ELb0ELb0E",
}
# K1's mutual form at the benchmark cell's leaf 128 (4 targets a thread,
# softened, no potential): its pair loop is the inner loop with MUFU.RSQ
# and STS (the source-side sums), its one-way loop the one without.
K1_MUTUAL_INSTANCE = "near_field_kernelILi4ELb0ELb0EEEvPK6float4PKiS"
# K3's cross form (targets against other sources: the ring, the tools).
K3_CROSS_INSTANCE = "allpairs_kernelILb0ELb0EEEvPKfPK6float4"
# K3's self-gravity form against the cross form (ms each) at these N.
SYM_SWEEP_N = (4096, 16384, 32768, 40960, 49152, 65536, 131072, 196608,
               262144)
# K8's and K11's instantiations on their tools' headline rows: K8 mode A,
# unroll 4, stride 4, 8 targets a thread (leaf 256); K11 at 8 packs with
# the potential, 8 targets a thread, "row" and "step".
EXP_INSTANCE = {
    ("near_probe", "A u4"): "near_probe_kernelILi0ELi4ELi4ELi8E",
    ("flat_tune2", "P=8 row"): "flat_lane_kernelILi8ELi8ELb1ELb1E",
    ("flat_tune2", "P=8 step"): "flat_lane_kernelILi8ELi8ELb1ELb0E",
}
# K5-K7's instantiations (variant code, precision), both precisions.
MMA_INSTANCE = {
    (name, p): f"allpairs_mma_kernelILi{direct_mma.VARIANTS[v]}ELi{p}E"
    for name, v in MMA_KERNELS.items() for p in direct_mma.PRECISIONS}


def reset_launch_counts():
    bh_kernels.reset_launch_counts()
    direct_kernels.reset_launch_counts()
    direct_mma.reset_launch_counts()
    near_probe.reset_launch_counts()
    near_flat.reset_launch_counts()


def launch_counts():
    return {**bh_kernels.LAUNCHES, **direct_kernels.LAUNCHES,
            **direct_mma.LAUNCHES, **near_probe.LAUNCHES,
            **near_flat.LAUNCHES}


def log(msg=""):
    print(msg, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(terms, flops_per_term, n_bytes, tc_flops=0):
    """The least time for `terms` interaction terms of flops_per_term FP32
    operations (a mean, where terms differ) and one rsqrt each, plus
    tc_flops on the tensor cores, moving n_bytes: bound_ms, bound_by
    ("operations" or "bytes") and the resource ("fp32", "mufu", "tensor",
    "hbm")."""
    secs = {"fp32": terms * flops_per_term / FP32_FLOPS,
            "mufu": terms / MUFU_RATE, "tensor": tc_flops / TF32_FLOPS,
            "hbm": n_bytes / HBM_BYTES}
    res = max(secs, key=secs.get)
    return {"bound_ms": secs[res] * 1e3,
            "bound_by": "bytes" if res == "hbm" else "operations",
            "bound_resource": res, "terms": terms,
            "flops_per_term": flops_per_term}


def with_share(rec, work):
    """rec updated with the bound of `work` (bound()'s result) and the
    share bound / time; for quadrupole terms also the share against the
    former term's FLOPS_QUADRUPOLE_OLD operations."""
    rec.update(work)
    rec["share"] = rec["bound_ms"] / rec["ms"]
    if rec.get("flops_per_term") == FLOPS_QUADRUPOLE:
        old = bound(rec["terms"], FLOPS_QUADRUPOLE_OLD, 0)["bound_ms"]
        rec["share_57ops"] = old / rec["ms"]
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
    """Build and load the kernels; returns {kernel: {"sass_per_pair": SASS
    instructions a pair of its main-path inner loop}} (K5-K7: the loop
    with HMMA, at 3xTF32, and "sass_per_pair_tf32" at one pass; K8 and
    K11: {row: instructions a pair} and {row: registers} of the
    EXP_INSTANCE rows)."""
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
        per_pair[name] = {"sass_per_pair": rec["per_pair"]}
        regs, smem = usage.get(found[0], (None, None))
        log(f"SASS {name} ({instance}): inner loop {rec['instructions']} "
            f"instructions, {rec['pairs']} MUFU.RSQ, {rec['per_pair']:.3f} a "
            f"pair; {regs} registers, {smem} bytes static shared; "
            f"{json.dumps(rec['opcodes'])}")
    found = [m for m in loops if K1_MUTUAL_INSTANCE in m]
    if len(found) != 1:
        raise AssertionError(f"near_field mutual: {len(found)} kernels "
                             f"match {K1_MUTUAL_INSTANCE} in the SASS")
    regs, smem = usage.get(found[0], (None, None))
    for rec in loops[found[0]]["loops"]:
        kind = "mutual" if "STS" in rec["opcodes"] else "one-way"
        per_pair["near_field"][f"sass_per_pair_{kind}_r4"] = rec["per_pair"]
        log(f"SASS near_field mutual form, {kind} loop "
            f"({K1_MUTUAL_INSTANCE}): {rec['instructions']} instructions, "
            f"{rec['pairs']} MUFU.RSQ, {rec['per_pair']:.3f} a pair term "
            f"(mutual: an unordered pair); {regs} registers; "
            f"{json.dumps(rec['opcodes'])}")
    found = [m for m in loops if K3_CROSS_INSTANCE in m]
    if len(found) != 1:
        raise AssertionError(f"allpairs: {len(found)} kernels match "
                             f"{K3_CROSS_INSTANCE} in the SASS")
    rec = loops[found[0]]
    per_pair["allpairs"]["sass_per_pair_cross"] = rec["per_pair"]
    log(f"SASS allpairs, cross form ({K3_CROSS_INSTANCE}): inner loop "
        f"{rec['instructions']} instructions, {rec['pairs']} MUFU.RSQ, "
        f"{rec['per_pair']:.3f} a pair; self-gravity form "
        f"{per_pair['allpairs']['sass_per_pair'] / 2:.3f} an ordered pair")
    for (name, label), instance in EXP_INSTANCE.items():
        found = [m for m in loops if instance in m]
        if len(found) != 1:
            raise AssertionError(f"{name}: {len(found)} kernels match "
                                 f"{instance} in the SASS")
        rec = loops[found[0]]
        regs, smem = usage.get(found[0], (None, None))
        per_pair.setdefault(name, {}).setdefault("sass_per_pair", {})[
            label] = rec["per_pair"]
        per_pair[name].setdefault("registers", {})[label] = regs
        log(f"SASS {name} {label} ({instance}): inner loop "
            f"{rec['instructions']} instructions, {rec['pairs']} MUFU.RSQ, "
            f"{rec['per_pair']:.3f} a pair (K1: "
            f"{per_pair['near_field']['sass_per_pair']:.3f}); "
            f"{rec['kernel_instructions']} in the kernel; {regs} "
            f"registers, {smem} bytes static shared; "
            f"{json.dumps(rec['opcodes'])}")
    for (name, p), instance in MMA_INSTANCE.items():
        found = [m for m in loops if instance in m]
        if len(found) != 1 or "tensor_loop" not in loops[found[0]]:
            raise AssertionError(f"{name}: no tensor-core loop of {instance} "
                                 "in the SASS")
        rec = loops[found[0]]["tensor_loop"]
        key = "sass_per_pair" if p == 3 else "sass_per_pair_tf32"
        per_pair.setdefault(name, {})[key] = rec["per_pair"]
        regs, smem = usage.get(found[0], (None, None))
        log(f"SASS {name} precision {p} ({instance}): tensor-core loop "
            f"{rec['instructions']} instructions, {rec['pairs']} MUFU.RSQ, "
            f"{rec['per_pair']:.3f} a pair (K3's cross form: "
            f"{per_pair['allpairs']['sass_per_pair_cross']:.3f}); {regs} "
            f"registers, {smem} bytes static shared; "
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


def busy_share(dev_ms, ms):
    return "not measured" if dev_ms is None else f"{dev_ms / ms:.3f}"


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
                fv=fv, nodes8=nodes8, work=bh_kernels.near_work(nv),
                order=bh_kernels.far_order(fv))


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
    children = int(children_per_leaf(L).sum())
    flops = FLOPS_QUADRUPOLE if L["nodes8"].shape[1] >= 9 else FLOPS_MONOPOLE
    return bound(children * leaf, flops, out_bytes + nbytes(
        tgt, L["nodes8"], L["fk"], L["fv"]))


def children_per_leaf(L):
    """(L,) the accepted children (set mask bits) of each target leaf's
    K2 list: the node rows K2 sweeps for it."""
    mask = torch.where(L["fv"], L["fk"] & 0xFF, 0)
    return sum(((mask >> b) & 1).sum(1) for b in range(8))


def balance(counts):
    """'mean M max X (max/mean R)' of a per-leaf count (L,)."""
    mean, top = float(counts.float().mean()), int(counts.max())
    return f"mean {mean:.1f} max {top} (max/mean {top / mean:.2f})"


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
        # on the items and K2 in the launch order the paths build with the
        # lists.
        full = args(L)
        fkw = (dict(kw, work=L["work"]) if name == "near_field" else
               dict(kw, order=L["order"]))
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
    # The window form with leaf_lo = 0 over one shard that holds every
    # leaf: the same items, bit for bit the unwindowed form, the same time.
    n_ids = (0, L["tgt"].shape[0])
    wwork = bh_kernels.near_work(L["nv"], L["ni"], n_ids)
    if not all(torch.equal(a, b) for a, b in zip(wwork[:2], L["work"][:2])):
        raise AssertionError("near_field: the window items over every leaf "
                             "differ from the unwindowed items")
    unwin = bh_kernels.near_field(*near_args(L), compute_pot=False,
                                  work=L["work"], **kw)
    win = bh_kernels.near_field(*near_args(L), compute_pot=False, work=wwork,
                                leaf_lo=0, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(unwin, win)):
        raise AssertionError("near_field: the window form with leaf_lo = 0 "
                             "differs from the unwindowed form")
    _, rec["ms_window_lo0"] = cuda_ms(lambda: bh_kernels.near_field(
        *near_args(L), compute_pot=False, work=wwork, leaf_lo=0, **kw),
        KERNEL_REPS)
    log(f"near_field at N={cfg.n}: the window form with leaf_lo = 0 over "
        f"every leaf equals the unwindowed form bit for bit; "
        f"{rec['ms_window_lo0']:.3f} ms against {rec['ms']:.3f} ms")
    del unwin, win
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
    far = out["far_octet"]
    far["deterministic"] = repeat_equal(
        "far_octet", lambda: bh_kernels.far_octet(*far_args(L),
                                                  compute_pot=False, **kw))
    far["children_t0"] = balance(children_per_leaf(L))
    # The launch order's own cost: once per list build, as the items'. And
    # what it buys: the same lists with the leaves in curve order.
    bh_kernels.far_order(L["fv"])                            # warm-up
    _, far["order_ms"] = cuda_ms(lambda: bh_kernels.far_order(L["fv"]),
                                 KERNEL_REPS)
    curve = torch.arange(n_leaves, dtype=torch.int32, device=dev)
    _, far["ms_curve_order"] = cuda_ms(lambda: bh_kernels.far_octet(
        *far_args(L), compute_pot=False, order=curve, **kw), KERNEL_REPS)
    log(f"far_octet at N={cfg.n}: accepted children per target leaf "
        f"{far['children_t0']}; {far['terms']:.4e} node-target terms; "
        f"share against {FLOPS_QUADRUPOLE_OLD} operations a term "
        f"{far.get('share_57ops', float('nan')):.3f}; launch order built in "
        f"{far['order_ms']:.3f} ms; {far['ms_curve_order']:.3f} ms with the "
        "leaves in curve order; repeat launches bit-equal")
    del L, state

    # K1 and K2 again on the lists of the state after LATER_STEPS octet
    # steps, where the t = 0 lists' longest rows have relaxed.
    sim = Simulation(cfg, device=DEVICE)
    sim.step(LATER_STEPS)
    L = lists_for(sim.cfg, sim.state)
    del sim
    full = far_args(L)
    got = bh_kernels.far_octet(*full, compute_pot=False, **kw)
    far["max_abs_err"] = max(far["max_abs_err"], max_err(
        f"far_octet N={cfg.n} after {LATER_STEPS} steps", got,
        bh_kernels.far_octet_plain(*full, compute_pot=False, **kw)))
    _, ms = cuda_ms(lambda: bh_kernels.far_octet(
        *full, compute_pot=False, order=L["order"], **kw), KERNEL_REPS)
    later = with_share({"ms": ms}, list_work("far_octet", L))
    far.update({f"{k}_step{LATER_STEPS}": later[k]
                for k in ("ms", "bound_ms", "share", "terms")})
    far[f"children_step{LATER_STEPS}"] = balance(children_per_leaf(L))
    per_term = [far["ms"] / far["terms"], ms / later["terms"]]
    far["per_term_ratio"] = max(per_term) / min(per_term)
    log(f"far_octet on the lists after {LATER_STEPS} steps: accepted "
        f"children per target leaf {far[f'children_step{LATER_STEPS}']}; "
        f"{later['terms']:.4e} node-target terms (t = 0: "
        f"{far['terms']:.4e}); kernel {ms:.3f} ms, bound "
        f"{later['bound_ms']:.3f} ms, share {later['share']:.3f}; time per "
        f"term {per_term[1] * 1e9:.4f} ps against {per_term[0] * 1e9:.4f} ps "
        f"at t = 0 (ratio {far['per_term_ratio']:.3f})")
    del full, got
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
    # targets a thread, K2's blocks are one warp), where K1 and K2 are timed
    # too.
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
        full = far_args(L)
        bh_kernels.far_octet(*full, compute_pot=False, order=L["order"], **kw)
        _, ms = cuda_ms(lambda: bh_kernels.far_octet(
            *full, compute_pot=False, order=L["order"], **kw), KERNEL_REPS)
        at = with_share({"ms": ms}, list_work("far_octet", L))
        out["far_octet"].update({f"{k}_leaf128": at[k]
                                 for k in ("ms", "bound_ms", "share")})
        log(f"far_octet at {label} (compute_pot=False): kernel {ms:.3f} ms, "
            f"bound {at['bound_ms']:.3f} ms, share {at['share']:.3f}; "
            f"accepted children per target leaf "
            f"{balance(children_per_leaf(L))}")
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
    rec["self_gravity"] = sym_sweep(cfg, sample)
    return rec


def sym_sweep(cfg, sample):
    """K3's self-gravity form (allpairs_self with N_SYM lowered to 1)
    beside its cross form (allpairs(pos, pos, mass)) at SYM_SWEEP_N,
    compute_pot=False, in turns (cross, self, self, cross; the least of
    each), each held to the plain version on sampled targets: {N: {"ms",
    "cross_ms", "chunks", "slots_bytes", "max_abs_err"}}; at the main
    path's N also its share of the bound."""
    dev = torch.device(DEVICE)
    kw = dict(softening=cfg.softening, compute_pot=False)
    out = {}
    n_sym = direct_kernels.N_SYM
    direct_kernels.N_SYM = 1
    try:
        for n in SYM_SWEEP_N:
            state = init_simulation(cfg.replace(n=n), dev,
                                    compute_forces=False)
            pos, mass = state.pos, state.mass
            sym = lambda: direct_kernels.allpairs_self(pos, mass, **kw)
            cross = lambda: direct_kernels.allpairs(pos, pos, mass, **kw)
            rows = sample(n)
            err = max_err(f"allpairs_self N={n}", (sym()[rows],),
                          (direct_kernels.allpairs_plain(
                              pos[rows], pos, mass, **kw),))
            cross()
            reps = max(KERNEL_REPS, int(2e10 / (n * n)))
            times = {"cross": [], "self": []}
            for name in ("cross", "self", "self", "cross"):
                times[name].append(cuda_ms(sym if name == "self" else cross,
                                           reps)[1])
            chunks = direct_kernels.sym_chunks(
                n, torch.cuda.get_device_properties(0).multi_processor_count)
            row = {"ms": min(times["self"]), "cross_ms": min(times["cross"]),
                   "chunks": chunks, "slots_bytes": (
                       chunks + direct_kernels.sym_tiles(n) // 2) * n * 16,
                   "max_abs_err": err}
            if n == cfg.n:
                with_share(row, bound(n * n, FLOPS_MONOPOLE, n * 28))
            out[n] = row
            log(f"allpairs_self at N={n}: self-gravity {row['ms']:.3f} ms, "
                f"cross {row['cross_ms']:.3f} ms (ratio "
                f"{row['ms'] / row['cross_ms']:.3f}), {chunks} chunks, "
                f"slots {row['slots_bytes'] / 1e6:.1f} MB, max abs err "
                f"{err:.3e} on {len(rows)} targets")
    finally:
        direct_kernels.N_SYM = n_sym
    return out


def phase_mma():
    """K5-K7 (ops/direct_mma.py): each at both precisions against its plain
    version in full at N = 16384 (Hilbert-sorted Plummer, the tool's
    accuracy inputs) and launched twice for the same bits, V3 and V1 also
    at an odd N; at N = 262144 each 3xTF32 kernel against its plain
    version, timed. Then the tool's table (tools/mxu_allpairs.py: V0 = K3,
    V3, V1, V4 at precision 1 and 3; rms against the f64 sum at 16384, ms
    at 262144) with every launch count set to 0 just before and read just
    after: each of K5-K7 must launch, and V4 at 3xTF32 (and V0) stay below
    the all-pairs rms bound. Returns {kernel: numbers, launches}."""
    dev = torch.device(DEVICE)
    eps = mxu_allpairs.EPS
    out = {name: {"max_abs_err": 0.0, "deterministic": True}
           for name in MMA_KERNELS}
    sorted16 = mxu_allpairs.plummer_sorted(MMA_PARITY_N, dev)
    odd = init_simulation(SimConfig(n=ODD_N, ic="plummer", softening=eps),
                          dev, compute_forces=False)
    for name, v in MMA_KERNELS.items():
        kernel, plain = direct_mma.WRAPPERS[v], direct_mma.PLAIN[v]
        cases = [(f"N={MMA_PARITY_N} sorted", sorted16)]
        if v != "v4":
            cases.append((f"N={ODD_N}", (odd.pos, odd.mass)))
        for p in direct_mma.PRECISIONS:
            kw = dict(softening=eps, precision=p)
            for label, (pos, mass) in cases:
                err = max_err(f"{name} precision {p} {label}",
                              (kernel(pos, mass, **kw),),
                              (plain(pos, mass, **kw),))
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
                log(f"{name} precision {p} {label}: max abs err {err:.3e}")
            repeat_equal(f"{name} precision {p}",
                         lambda: (kernel(*sorted16, **kw),))
    del sorted16, odd
    pos, mass = mxu_allpairs.plummer_sorted(mxu_allpairs.N_THROUGHPUT, dev)
    for name, v in MMA_KERNELS.items():
        kw = dict(softening=eps, precision=3)
        got = direct_mma.WRAPPERS[v](pos, mass, **kw)
        want, out[name]["plain_ms"] = cuda_ms(
            lambda: direct_mma.PLAIN[v](pos, mass, **kw))
        err = max_err(f"{name} precision 3 N={pos.shape[0]}", (got,), (want,))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        log(f"{name} precision 3 N={pos.shape[0]}: max abs err {err:.3e}; "
            f"plain {out[name]['plain_ms']:.1f} ms")
        del got, want
    del pos, mass

    reset_launch_counts()
    table = mxu_allpairs.table()
    launches = launch_counts()
    log(f"mxu_allpairs table: launches {json.dumps(launches)}")
    by = {(r["kernel"], r["precision"]): r for r in table}
    for (v, p), r in by.items():
        if v in ("v0", "v4") and p in (None, 3) and \
                not r["rms_err"] < MMA_RMS_BOUND:
            raise AssertionError(f"{r['variant']}: rms {r['rms_err']:.3e} "
                                 f">= {MMA_RMS_BOUND}")
    for name, v in MMA_KERNELS.items():
        if launches[name] <= 0:
            raise AssertionError(f"mxu_allpairs table: {name} not launched")
        rec = out[name]
        rec["launches"] = launches[name]
        for p, sfx in ((1, "_tf32"), (3, "")):
            r = by[(v, p)]
            work = bound(r["pairs"], r["fp32_ops"] / r["pairs"], r["bytes"],
                         r["tc_flops"])
            rec.update({f"ms{sfx}": r["ms"], f"rms_err{sfx}": r["rms_err"],
                        f"pairs_per_s{sfx}": r["pairs_per_s"],
                        f"bound_ms{sfx}": work["bound_ms"],
                        f"bound_resource{sfx}": work["bound_resource"],
                        f"share{sfx}": work["bound_ms"] / r["ms"],
                        f"floor_share{sfx}": r["mufu_floor_ms"] / r["ms"]})
        rec["bound_by"] = work["bound_by"]  # 3xTF32's
        rec.update({"terms": by[(v, 3)]["pairs"],
                    "band_pairs": by[(v, 3)]["band_pairs"],
                    "mufu_floor_ms": by[(v, 3)]["mufu_floor_ms"]})
        log(f"{name} at N={mxu_allpairs.N_THROUGHPUT}: 3xTF32 "
            f"{rec['ms']:.3f} ms (share {rec['share']:.3f}), TF32 "
            f"{rec['ms_tf32']:.3f} ms (share {rec['share_tf32']:.3f}); MUFU "
            f"floor {rec['mufu_floor_ms']:.3f} ms; K3 "
            f"{by[('v0', None)]['ms']:.3f} ms; rms at N={MMA_PARITY_N} {rec['rms_err']:.3e} / "
            f"{rec['rms_err_tf32']:.3e}; plain {rec['plain_ms']:.1f} ms")
    return out


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

    # The launch orders the gather path builds with its lists.
    orders = [bh_kernels.far_order(valid) for *_, valid in classes]

    def both(fn):
        extra = ([{}] * len(classes) if fn is plain else
                 [{"order": o} for o in orders])
        return [fn(tgt, table, idx, valid, compute_pot=False, **kw, **x)
                for (_, table, idx, valid), x in zip(classes, extra)]

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
    rec["deterministic"] = repeat_equal(
        "far_gather", lambda: [t for out in both(kernel) for t in out])
    _, rec["order_ms"] = cuda_ms(lambda: [bh_kernels.far_order(v)
                                          for *_, v in classes], KERNEL_REPS)
    log(f"far_gather at N={cfg.n}, upper + leaf list (compute_pot=False): "
        f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_resource']}), share "
        f"{rec['share']:.3f} (against {FLOPS_QUADRUPOLE_OLD} operations a "
        f"term {rec.get('share_57ops', float('nan')):.3f}); launch orders "
        f"built in {rec['order_ms']:.3f} ms; full max abs err "
        f"{rec['max_abs_err']:.3e}; repeat launches bit-equal")
    rows = torch.linspace(0, tgt.shape[0] - 1, SAMPLE_ROWS, device=dev).long()
    held(f"N={cfg.n}, {SAMPLE_ROWS} sampled target leaves", tgt, classes,
         True, rows)
    del state, tgt, classes, got

    # In full at N = 65536 (leaf 256) and at N = 262144 with its auto leaf
    # size 128 (4 targets a thread), both potential settings.
    for n, leaf in ((PARITY_N, None), (LEAF128_N, 0)):
        small = cfg.replace(n=n, bh_near_budget=0, bh_far_budget=0)
        if leaf is not None:
            small = small.replace(bh_leaf_size=leaf)
        state = init_simulation(small, dev, compute_forces=False)
        small = calibrate_budgets(small, state)
        tgt, classes = gather_lists_for(small, state)
        for compute_pot in (True, False):
            held(f"N={n}, leaf {small.resolve_bh_leaf_size()}", tgt, classes,
                 compute_pot)

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


def drive_path(label, cfg, kernels, steps, rms_bound, rms_k=RMS_SAMPLES):
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
                                     k=rms_k)
        log(f"{label}: rms force error vs direct sum after {step_label} "
            f"(k={min(rms_k, cfg.n)}): {rms:.4e}")
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
    dev_step = measure.busy_ms(lambda: sim.step(1))
    dev_block = measure.busy_ms(lambda: sim.step(REUSE_STEPS))
    ms_reuse = ms_block / REUSE_STEPS
    log(f"octet path: ms/step at N={cfg.n}: per-step {ms_step:.2f} (mean of "
        f"{STEP_REPS} step(1)), rebuild every {cfg.bh_rebuild_every} "
        f"{ms_reuse:.2f} (step({REUSE_STEPS})); device busy per step "
        f"{dev_step or float('nan'):.2f} ms (share "
        f"{busy_share(dev_step, ms_step)}) and "
        f"{(dev_block or float('nan')) / REUSE_STEPS:.2f} ms (share "
        f"{busy_share(dev_block and dev_block / REUSE_STEPS, ms_reuse)})")
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
    # The same state through both far modes (tests/test_bh.py:752), before
    # the timed steps carry it past the budgets calibrated at t = 0.
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

    _, ms_step = cuda_ms(lambda: sim.step(1), STEP_REPS)
    dev_step = measure.busy_ms(lambda: sim.step(1))
    log(f"gather path: ms/step at N={cfg.n}: {ms_step:.2f} (mean of "
        f"{STEP_REPS} step(1); gather rebuilds the lists every step); device "
        f"busy per step {dev_step or float('nan'):.2f} ms (share "
        f"{busy_share(dev_step, ms_step)})")
    report_diagnostics("gather path", sim)
    return launches


def phase_crossover():
    """ms/step of force="direct_pallas" against per-step Barnes-Hut
    (theta 0.72, quadrupole), Plummer, track_potential=False, with the
    method force="auto" picks on the card (SimConfig.AUTO_BH_CROSSOVER_CUDA).
    Each path's time is the median of CROSSOVER_GROUPS means of STEP_REPS
    step(1). Fails where auto picks a path more than CROSSOVER_SLACK times
    slower than the other."""
    for n in CROSSOVER_N:
        row = {"n": n}
        for force in ("direct_pallas", "barnes_hut"):
            cfg = SimConfig(n=n, ic="plummer", softening=0.01, theta=0.72,
                            bh_multipole=2, force=force,
                            track_potential=False, bh_rebuild_every=1)
            sim = Simulation(cfg, device=DEVICE)
            sim.step(1)                                      # warm-up
            row[force] = statistics.median(
                cuda_ms(lambda: sim.step(1), STEP_REPS)[1]
                for _ in range(CROSSOVER_GROUPS))
            del sim
        row["faster"] = min(("direct_pallas", "barnes_hut"), key=row.get)
        auto = SimConfig(n=n).resolve_force(DEVICE)
        other = "barnes_hut" if auto == "direct_pallas" else "direct_pallas"
        row["auto"] = auto
        row["auto_over_other"] = row[auto] / row[other]
        log("crossover " + json.dumps(row))
        if row["auto_over_other"] > CROSSOVER_SLACK:
            raise AssertionError(
                f"crossover: at N={n} force='auto' picks {auto}, "
                f"{row['auto_over_other']:.2f}x slower than {other}")


def staged_lists_for(cfg, gather_far_budget, state):
    """The staged lists of the per-step path at state for cfg (calibrated
    budgets): the near list, the octet far list (K2) and the gather far
    list over every level's node table (K4, gather_far_budget node
    entries), with the work items and launch orders the paths build."""
    leaf = cfg.resolve_bh_leaf_size()
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    n_leaves = n_pad // leaf
    far, rej2 = bh.traverse(tree, cfg.theta, stop_level=2)
    kw = dict(theta=cfg.theta, start_leaf=0, n_slice=n_leaves,
              near_budget=cfg.bh_near_budget,
              cand2_budget=cfg.bh_cand2_budget,
              cand1_budget=cfg.bh_cand_budget, dtype=torch.float32)
    ni, nv, fk, fv, nodes8, of = bh.build_interaction_lists_staged(
        tree, far, rej2, far_budget=cfg.bh_far_budget, octet_far=True, **kw)
    _, _, gi, gv, nodes_all, of_g = bh.build_interaction_lists_staged(
        tree, far, rej2, far_budget=gather_far_budget, octet_far=False, **kw)
    if int(of) != 0 or int(of_g) != 0:
        raise AssertionError(f"staged list overflow {int(of)} / {int(of_g)} "
                             "at calibrated budgets")
    return dict(pos_s=pos_s, mass_s=mass_s,
                tgt=pos_s.reshape(n_leaves, leaf, 3), ni=ni, nv=nv, fk=fk,
                fv=fv, nodes8=nodes8, gi=gi, gv=gv, nodes_all=nodes_all,
                work=bh_kernels.near_work(nv),
                order=bh_kernels.far_order(fv),
                gorder=bh_kernels.far_order(gv))


def phase_staged_parity(staged_json, kernels):
    """K1, K2 and K4 on the staged t = 0 lists at N = 8M: timed in full
    with their bound, held against their plain versions on sampled target
    leaves (both potential settings), K2 on a duplicate-octet row. Adds
    the numbers to `kernels` under keys ending in _staged8m."""
    dev = torch.device(DEVICE)
    cfg = SimConfig.from_json(staged_json)
    t0 = time.perf_counter()
    state = init_simulation(cfg, dev, compute_forces=False)
    cfg = calibrate_budgets(cfg, state)
    gcfg = calibrate_budgets(cfg.replace(bh_far_mode="gather",
                                         bh_far_budget=0), state)
    L = staged_lists_for(cfg, gcfg.bh_far_budget, state)
    torch.cuda.synchronize()
    n_leaves, leaf, _ = L["tgt"].shape
    near_n = L["nv"].sum(1)
    items = torch.clamp((near_n + bh_kernels.NEAR_CHUNK - 1)
                        // bh_kernels.NEAR_CHUNK, min=1)
    log(f"staged N={cfg.n}: {n_leaves} leaves of {leaf}, refine "
        f"{cfg.resolve_bh_refine()}; calibrated budgets near "
        f"{cfg.bh_near_budget} far {cfg.bh_far_budget} (gather "
        f"{gcfg.bh_far_budget}) cand2 {cfg.bh_cand2_budget} cand1 "
        f"{cfg.bh_cand_budget}; near entries per leaf {balance(near_n)}; "
        f"K1 work items per leaf {balance(items)} ({int(items.sum())}"
        f" items); K2 accepted children per leaf "
        f"{balance(children_per_leaf(L))}; far octets per leaf "
        f"{balance(L['fv'].sum(1))}; K4 node entries per leaf "
        f"{balance(L['gv'].sum(1))} ({time.perf_counter() - t0:.1f} s)")
    kw = dict(g=cfg.g, softening=cfg.softening)
    gather_args = (lambda rows=None: (L["tgt"], L["nodes_all"], L["gi"],
                                      L["gv"]) if rows is None else
                   (L["tgt"][rows].contiguous(), L["nodes_all"],
                    L["gi"][rows].contiguous(), L["gv"][rows].contiguous()))
    funcs = {"near_field": (bh_kernels.near_field,
                            bh_kernels.near_field_plain,
                            lambda rows=None: near_args(L, rows),
                            dict(work=L["work"])),
             "far_octet": (bh_kernels.far_octet, bh_kernels.far_octet_plain,
                           lambda rows=None: far_args(L, rows),
                           dict(order=L["order"])),
             "far_gather": (bh_kernels.far_gather,
                            bh_kernels.far_gather_plain, gather_args,
                            dict(order=L["gorder"]))}
    rows = torch.linspace(0, n_leaves - 1, STAGED_SAMPLE_ROWS,
                          device=dev).long()
    out_bytes = n_leaves * leaf * 16
    for name, (kernel, plain, args, built) in funcs.items():
        full = args()
        kernel(*full, compute_pot=False, **kw, **built)          # warm-up
        _, ms = cuda_ms(lambda: kernel(*full, compute_pot=False, **kw,
                                       **built), KERNEL_REPS)
        if name == "far_gather":
            flops = (FLOPS_QUADRUPOLE if L["nodes_all"].shape[1] >= 9
                     else FLOPS_MONOPOLE)
            work = bound(int(L["gv"].sum()) * leaf, flops, out_bytes + nbytes(
                L["tgt"], L["nodes_all"], L["gi"], L["gv"]))
        else:
            work = list_work(name, L)
        rec = with_share({"ms": ms}, work)
        err = 0.0
        for compute_pot in (True, False):
            sub = args(rows)
            err = max(err, max_err(
                f"{name} staged N={cfg.n} {STAGED_SAMPLE_ROWS} rows "
                f"pot={compute_pot}",
                kernel(*sub, compute_pot=compute_pot, **kw),
                plain(*sub, compute_pot=compute_pot, **kw)))
        k = kernels[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k.update({f"{key}_staged8m": rec[key]
                  for key in ("ms", "bound_ms", "share", "terms")})
        log(f"{name} on the staged N={cfg.n} lists (compute_pot=False): "
            f"kernel {ms:.3f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_resource']}), share {rec['share']:.3f}, "
            f"{rec['terms']:.4e} terms; {STAGED_SAMPLE_ROWS} sampled target "
            f"leaves against the plain version, both potential settings: "
            f"max abs err {err:.3e}")
    # The work items' and launch orders' own cost, once per list build.
    for label, fn in (("K1 work items", lambda: bh_kernels.near_work(L["nv"])),
                      ("K2 launch order",
                       lambda: bh_kernels.far_order(L["fv"])),
                      ("K4 launch order",
                       lambda: bh_kernels.far_order(L["gv"]))):
        fn()
        _, ms = cuda_ms(fn, KERNEL_REPS)
        log(f"staged N={cfg.n}: {label} built in {ms:.3f} ms (host wait "
            "included)")

    # A row naming one octet in keys with disjoint masks, as two parents
    # of branch factor < 8 emit them, against the plain version and one key
    # of the union mask.
    big = bh.INT32_MAX
    o = int(L["fk"][0, 0]) >> 8
    split = torch.tensor([[(o << 8) | 0x0F, (o << 8) | 0x30, (o << 8) | 0xC0,
                           big]], dtype=torch.int32, device=dev)
    union = torch.tensor([[(o << 8) | 0xFF, big, big, big]],
                         dtype=torch.int32, device=dev)
    tgt = L["tgt"][:1].contiguous()
    args = (tgt, L["nodes8"], split, split != big)
    got = bh_kernels.far_octet(*args, **kw)
    err = max_err("far_octet duplicate-octet row", got,
                  bh_kernels.far_octet_plain(*args, **kw))
    err = max(err, max_err("far_octet duplicate-octet row against the "
                           "union key", got, bh_kernels.far_octet(
                               tgt, L["nodes8"], union, union != big, **kw)))
    kernels["far_octet"]["max_abs_err"] = max(
        kernels["far_octet"]["max_abs_err"], err)
    log(f"far_octet on a row of three keys for octet {o} with disjoint "
        f"masks: max abs err {err:.3e} against the plain version and the "
        "union key")
    return cfg


def phase_staged_path(staged_json):
    """The 8M staged config through Simulation, octet then gather."""
    cfg = SimConfig.from_json(staged_json)
    sim, launches = drive_path("staged path", cfg, ("near_field", "far_octet"),
                               (1, REUSE_STEPS), RMS_BOUND)
    c = sim.cfg
    log(f"staged path: refine {c.resolve_bh_refine()}, calibrated budgets "
        f"near {c.bh_near_budget} far {c.bh_far_budget} cand2 "
        f"{c.bh_cand2_budget} cand1 {c.bh_cand_budget}")
    _, ms_step = cuda_ms(lambda: sim.step(1), STAGED_STEP_REPS)
    _, ms_block = cuda_ms(lambda: sim.step(REUSE_STEPS))
    dev_step = measure.busy_ms(lambda: sim.step(1))
    dev_block = measure.busy_ms(lambda: sim.step(REUSE_STEPS))
    ms_reuse = ms_block / REUSE_STEPS
    log(f"staged path: ms/step at N={cfg.n}: per-step {ms_step:.2f} (mean of "
        f"{STAGED_STEP_REPS} step(1)), rebuild every {c.bh_rebuild_every} "
        f"{ms_reuse:.2f} (step({REUSE_STEPS})); device busy per step "
        f"{dev_step or float('nan'):.2f} ms (share "
        f"{busy_share(dev_step, ms_step)}) and "
        f"{(dev_block or float('nan')) / REUSE_STEPS:.2f} ms (share "
        f"{busy_share(dev_block and dev_block / REUSE_STEPS, ms_reuse)})")
    octet_cfg = c
    del sim
    torch.cuda.empty_cache()

    gcfg = cfg.replace(bh_far_mode="gather")
    gsim, glaunches = drive_path("staged gather path", gcfg,
                                 ("near_field", "far_gather"), (1,),
                                 RMS_BOUND)
    c, s = gsim.cfg, gsim.state
    kw = dict(leaf_size=c.resolve_bh_leaf_size(), theta=c.theta, g=c.g,
              softening=c.softening, near_budget=c.bh_near_budget,
              curve=c.bh_curve, multipole=c.bh_multipole,
              max_levels=c.bh_max_levels, compute_pot=False, refine="staged")
    ag, _, og = bh.bh_accel(s.pos, s.mass, far0_budget=c.bh_far_budget,
                            cand_budgets=(c.bh_cand2_budget,
                                          c.bh_cand_budget),
                            far_mode="gather", **kw)
    ao, _, oo = bh.bh_accel(s.pos, s.mass, far0_budget=octet_cfg.bh_far_budget,
                            cand_budgets=(octet_cfg.bh_cand2_budget,
                                          octet_cfg.bh_cand_budget),
                            far_mode="octet", **kw)
    rel = float(torch.linalg.norm(ag - ao) / torch.linalg.norm(ag))
    log(f"staged gather path: gather far budget {c.bh_far_budget} node "
        f"entries; forces against the octet path on the same state: "
        f"relative norm {rel:.3e}; overflow {int(og)} / {int(oo)}")
    if int(og) != 0 or int(oo) != 0 or not rel < GATHER_OCTET_BOUND:
        raise AssertionError(f"staged gather vs octet: relative norm "
                             f"{rel:.3e} (bound {GATHER_OCTET_BOUND}), "
                             f"overflow {int(og)} / {int(oo)}")
    del ag, ao
    _, ms_g = cuda_ms(lambda: gsim.step(1), STAGED_STEP_REPS)
    dev_g = measure.busy_ms(lambda: gsim.step(1))
    log(f"staged gather path: ms/step at N={cfg.n}: {ms_g:.2f} (mean of "
        f"{STAGED_STEP_REPS} step(1)); device busy per step "
        f"{dev_g or float('nan'):.2f} ms (share {busy_share(dev_g, ms_g)})")
    del gsim
    torch.cuda.empty_cache()
    return launches, glaunches, octet_cfg


def phase_galaxy_path(galaxy_json):
    cfg = SimConfig.from_json(galaxy_json)
    sim, launches = drive_path("galaxy path", cfg, ("near_field", "far_octet"),
                               (1, GALAXY_STEPS), RMS_BOUND)
    c = sim.cfg
    _, ms_step = cuda_ms(lambda: sim.step(1), STAGED_STEP_REPS)
    # The peak of a rebuild-8 run of the state (the CLI's `run` segments),
    # apart from the rms check's direct-sum temporaries.
    torch.cuda.reset_peak_memory_stats()
    sim.step(REUSE_STEPS)                                    # warm-up
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, ms_block = cuda_ms(lambda: sim.step(REUSE_STEPS))
    ms_reuse = ms_block / REUSE_STEPS
    log(f"galaxy path: ic {c.ic}, leaf {c.resolve_bh_leaf_size()} (auto), "
        f"refine {c.resolve_bh_refine()}, track_potential "
        f"{c.track_potential}; budgets near {c.bh_near_budget} far "
        f"{c.bh_far_budget} cand2 {c.bh_cand2_budget} cand1 "
        f"{c.bh_cand_budget}; ms/step per step {ms_step:.2f} (mean of "
        f"{STAGED_STEP_REPS} step(1)), rebuild every {c.bh_rebuild_every} "
        f"{ms_reuse:.2f} (step({REUSE_STEPS})); peak device memory of "
        f"step({REUSE_STEPS}) {peak:.2f} GiB")
    report_diagnostics("galaxy path", sim)
    del sim
    torch.cuda.empty_cache()
    return launches, {"ms_step": ms_step, "ms_reuse": ms_reuse,
                      "peak_gib": peak}


def cli_json(argv):
    """cli.main(argv) in this process; its standard output is captured and
    its JSON result returned (a one-line summary, or an indented object).
    Fails on a non-zero exit code."""
    from parallelnbody_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue().strip()
    try:
        out = json.loads(text)
    except json.JSONDecodeError:
        out = json.loads(text.splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"cli {argv[0]}: exit code {rc}: {text[-500:]}")
    return out, wall


def cli_launches(label, kernels):
    """The launch counts since the last reset; fails unless each of
    `kernels` was launched."""
    got = launch_counts()
    for name in kernels:
        if got[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched")
    return got


def box_pixels(ppm_path):
    """Pixels of the tree-box colour (255, 64, 64) in a binary PPM."""
    with open(ppm_path, "rb") as f:
        data = f.read()
    header, body = data.split(b"\n", 1)
    _, w, h, _ = header.split()
    img = torch.frombuffer(bytearray(body), dtype=torch.uint8).reshape(
        int(h), int(w), 3)
    return int((img == torch.tensor([255, 64, 64], dtype=torch.uint8))
               .all(-1).sum())


def phase_cli(galaxy, shown):
    """The command line on examples/galaxy_2m.json as shipped, with --steps
    and the output directories overridden: `run` for CLI_STEPS steps with
    snapshots, metrics and checkpoints, `run --resume` to CLI_RESUME_TO,
    held bit for bit against an uninterrupted run of CLI_RESUME_TO steps
    at the same cadences; `render --show-tree` on its trajectory; `tree`
    at the run's calibrated budgets; `bench` per step and with --run-steps
    16, against the galaxy path's Simulation times of this process; the
    two Barnes-Hut drift gates of tests/test_oracle.py through `oracle`;
    `python -m parallelnbody_tpu_torch info` in a subprocess. Launch counts
    are reset before each command and read after it."""
    from parallelnbody_tpu_torch.utils.io import (latest_checkpoint,
                                                  load_checkpoint)

    base = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(base, ignore_errors=True)

    def d(name):
        return os.path.join(base, name)

    cadence = ["--config", GALAXY_CONFIG, "--device", DEVICE, "--quiet",
               "--log-every", str(CLI_CADENCE), "--checkpoint-every",
               str(2 * CLI_CADENCE)]
    traj = ["--snapshot-every", str(CLI_CADENCE), "--snapshot-dir",
            d("traj"), "--metrics", d("metrics.jsonl"), "--checkpoint-dir",
            d("ck")]
    pair = ("near_field", "far_octet")
    out = {}

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run_a, wall_a = cli_json(["run", *cadence, *traj, "--steps",
                              str(CLI_STEPS)])
    out["launches"] = cli_launches("cli run", pair)
    out["run_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    reset_launch_counts()
    run_b, wall_b = cli_json(["run", *cadence, *traj, "--resume", "--steps",
                              str(CLI_RESUME_TO - CLI_STEPS)])
    cli_launches("cli run --resume", pair)
    reset_launch_counts()
    run_c, wall_c = cli_json(["run", *cadence, "--steps", str(CLI_RESUME_TO),
                              "--snapshot-every", "0", "--checkpoint-dir",
                              d("ck_ref")])
    cli_launches("cli run (uninterrupted)", pair)
    for label, rec, wall in (("run", run_a, wall_a),
                             ("run --resume", run_b, wall_b),
                             ("run (uninterrupted)", run_c, wall_c)):
        log(f"cli {label}: {json.dumps(rec)}; wall {wall:.2f} s with "
            f"set-up ({1e3 * rec['wall_s'] / rec['steps']:.2f} ms/step in "
            "the step loop, snapshots and checkpoints included)")
        if rec["bh_overflow"] != 0 or rec["force"] != "barnes_hut" or \
                not math.isfinite(rec["energy_drift"]):
            raise AssertionError(f"cli {label}: {rec}")
    out["run_ms_step"] = 1e3 * run_a["wall_s"] / run_a["steps"]
    with open(d("metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    seg_ms = [1e3 / r["steps_per_sec"] for r in records
              if "steps_per_sec" in r]
    log(f"cli run: {len(records)} metrics records; ms/step per segment of "
        f"{CLI_CADENCE} (the previous segment's writes included): "
        + ", ".join(f"{m:.2f}" for m in seg_ms))
    if len(seg_ms) != CLI_RESUME_TO // CLI_CADENCE:
        raise AssertionError(f"cli run: {len(seg_ms)} metrics records with "
                             "a rate")

    state_b, cfg_b = load_checkpoint(latest_checkpoint(d("ck")), DEVICE)
    state_c, _ = load_checkpoint(latest_checkpoint(d("ck_ref")), DEVICE)
    fields = ("pos", "vel", "acc", "pot", "time", "step")
    same = {f: bool(torch.equal(getattr(state_b, f), getattr(state_c, f)))
            for f in fields}
    log(f"cli resume: step {int(state_b.step)} after a checkpoint at step "
        f"{CLI_STEPS} against an uninterrupted run to step "
        f"{int(state_c.step)}: bit-equal {same}")
    if int(state_b.step) != CLI_RESUME_TO or not all(same.values()):
        raise AssertionError("cli resume: the resumed run differs from the "
                             "uninterrupted one")
    out["rms"] = rms_force_error_sample(
        state_b.pos, state_b.mass, state_b.acc, g=cfg_b.g,
        softening=cfg_b.softening, k=RMS_SAMPLES)
    log(f"cli run: rms force error vs direct sum at step {CLI_RESUME_TO} "
        f"(k={RMS_SAMPLES}): {out['rms']:.4e}")
    check_state("cli run", state_b, cfg_b.n)
    if not out["rms"] < RMS_BOUND:
        raise AssertionError(f"cli run: rms {out['rms']:.4e}")
    del state_b, state_c
    torch.cuda.empty_cache()

    rend, wall = cli_json(["render", d("traj"), "--show-tree", "--fmt", "ppm",
                           "--device", DEVICE])
    frames = sorted(os.listdir(rend["out_dir"]))
    boxes = box_pixels(os.path.join(rend["out_dir"], frames[-1]))
    log(f"cli render --show-tree: {rend['frames_rendered']} frames in "
        f"{wall:.2f} s; {boxes} box pixels in {frames[-1]}")
    if rend["frames_rendered"] != CLI_RESUME_TO // CLI_CADENCE or not boxes:
        raise AssertionError(f"cli render: {rend}, {boxes} box pixels")

    budgets = ["--bh-near-budget", str(cfg_b.bh_near_budget),
               "--bh-far-budget", str(cfg_b.bh_far_budget),
               "--bh-cand2-budget", str(cfg_b.bh_cand2_budget),
               "--bh-cand-budget", str(cfg_b.bh_cand_budget)]
    torch.cuda.reset_peak_memory_stats()
    tree, wall = cli_json(["tree", "--config", GALAXY_CONFIG, "--device",
                           DEVICE, *budgets])
    out["tree_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"cli tree at the run's budgets {budgets[1::2]}: refine "
        f"{tree['refine']}, {tree['n_leaves']} leaves, near leaves a target "
        f"{tree['near_leaves_per_target']}, overflow {tree['overflow']}, "
        f"requirements {tree['requirements']}; {wall:.2f} s, peak "
        f"{out['tree_peak_gib']:.2f} GiB (galaxy path "
        f"{galaxy['peak_gib']:.2f})")
    if tree["overflow"] != 0 or \
            out["tree_peak_gib"] > TREE_PEAK_SLACK * galaxy["peak_gib"]:
        raise AssertionError(f"cli tree: overflow {tree['overflow']}, peak "
                             f"{out['tree_peak_gib']:.2f} GiB")

    for label, extra, sim_ms in (
            ("per step", ["--iters", "3"], galaxy["ms_step"]),
            (f"--run-steps {REUSE_STEPS}", ["--iters", "2", "--run-steps",
                                            str(REUSE_STEPS)],
             galaxy["ms_reuse"])):
        reset_launch_counts()
        bench, wall = cli_json(["bench", "--config", GALAXY_CONFIG,
                                "--device", DEVICE, *extra])
        cli_launches(f"cli bench {label}", pair)
        log(f"cli bench {label}: {json.dumps(bench)}; Simulation in this "
            f"process {sim_ms:.2f} ms/step")
        out[f"bench_ms_{'reuse' if '--run-steps' in extra else 'step'}"] = \
            bench["ms_per_step"]
        if bench.get("overflow", 0) != 0 or \
                bench["ms_per_step"] > BENCH_SLACK * sim_ms:
            raise AssertionError(f"cli bench {label}: {bench}")

    for k in (1, 8):
        reset_launch_counts()
        rep, wall = cli_json([*ORACLE_GATE, "--device", DEVICE,
                              "--bh-rebuild-every", str(k)])
        cli_launches(f"cli oracle rebuild {k}", pair)
        log(f"cli oracle, rebuild every {k}: {json.dumps(rep)}; {wall:.2f} s")
        out[f"oracle_drift_{k}"] = rep["relative_drift"]
        if not rep["relative_drift"] < ORACLE_DRIFT or rep["bh_overflow"]:
            raise AssertionError(f"cli oracle rebuild {k}: {rep}")

    proc = subprocess.run([sys.executable, "-m", "parallelnbody_tpu_torch",
                           "info"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cli info: exit code {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    info = json.loads(proc.stdout)
    log(f"cli info (subprocess): device {info['device_name']}, version "
        f"{info['version']}, torch {info['torch']}, cuda {info['cuda']}, "
        f"resolved force {info['resolved_force']}")
    if info["device_name"] != shown:
        raise AssertionError(f"cli info: device {info['device_name']}")
    return out


def phase_sections(cfg8, xl_json):
    """Sections at 8M (bit for bit against one window) and the 32M config
    through Simulation."""
    dev = torch.device(DEVICE)
    c = cfg8
    state = init_simulation(c, dev)
    kw = dict(leaf_size=c.resolve_bh_leaf_size(), theta=c.theta, g=c.g,
              softening=c.softening, near_budget=c.bh_near_budget,
              far0_budget=c.bh_far_budget, curve=c.bh_curve,
              multipole=c.bh_multipole, max_levels=c.bh_max_levels,
              compute_pot=False, refine="staged",
              cand_budgets=(c.bh_cand2_budget, c.bh_cand_budget))
    a1, _, o1 = bh.bh_accel(state.pos, state.mass, sections=1, **kw)
    a4, _, o4 = bh.bh_accel(state.pos, state.mass, sections=SECTIONS_8M,
                            **kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(a1, a4)) and int(o1) == int(o4) == 0
    del a1, a4
    r1 = make_run(c.replace(bh_sections=1), 8)(state)
    r4 = make_run(c.replace(bh_sections=SECTIONS_8M), 8)(state)
    torch.cuda.synchronize()
    same_block = all(torch.equal(getattr(r1, f), getattr(r4, f))
                     for f in ("pos", "vel", "acc"))
    log(f"sections at N={c.n}: bh_accel in {SECTIONS_8M} windows against "
        f"one bit-equal: {same} (overflow {int(o1)} / {int(o4)}); one "
        f"rebuild-8 block bit-equal: {same_block}")
    if not (same and same_block):
        raise AssertionError("sectioned results differ from unsectioned")
    del state, r1, r4
    torch.cuda.empty_cache()

    xcfg = SimConfig.from_json(xl_json)
    leaf = xcfg.resolve_bh_leaf_size()
    n_leaves = bh.plan_tree(xcfg.n, leaf, xcfg.bh_max_levels)[0]
    resolved = bh.resolve_sections(xcfg.bh_sections, n_leaves,
                                   xcfg.resolve_bh_refine())
    runs = [(f"32M path (auto sections = {resolved})", xcfg)]
    if resolved == 1:
        runs.append((f"32M path (bh_sections={XL_SECTIONS})",
                     xcfg.replace(bh_sections=XL_SECTIONS)))
    launches = None
    for label, cfg in runs:
        sim, got = drive_path(label, cfg, ("near_field", "far_octet"), (1,),
                              RMS_BOUND, rms_k=XL_RMS_SAMPLES)
        launches = launches or got
        _, ms = cuda_ms(lambda: sim.step(1), 2)
        log(f"{label}: ms/step {ms:.2f} (mean of 2 step(1)); budgets near "
            f"{sim.cfg.bh_near_budget} far {sim.cfg.bh_far_budget} cand2 "
            f"{sim.cfg.bh_cand2_budget} cand1 {sim.cfg.bh_cand_budget}")
        del sim
        torch.cuda.empty_cache()
    return launches


def phase_ics():
    """Each IC family through Barnes-Hut on the card at N = IC_N, step(1)
    (t = 0 budget calibration, K1 and K2 on its tree, overflow 0); the
    reference's compat profile (the plain direct sum); a Barnes-Hut run
    with softening 0. IC_N lies below the card's crossover, so the IC
    cases name Barnes-Hut: force="auto" would send them to K3."""
    # The reference's slab at its own scale (reference_compat_config's
    # size): at ic_size 1 its speeds of 250-500 carry the particles five
    # slab widths in one step, past any budget calibrated at t = 0.
    cases = [(name, SimConfig(n=IC_N, ic=name, force="barnes_hut",
                              ic_size=200.0 if name == "reference_slab"
                              else 1.0))
             for name in IC_KINDS]
    cases.append(("reference_compat_config()", reference_compat_config()))
    cases.append(("plummer, barnes_hut, softening 0",
                  SimConfig(n=IC_N, force="barnes_hut", softening=0.0)))
    for label, cfg in cases:
        reset_launch_counts()
        sim = Simulation(cfg, device=DEVICE)
        sim.step(1)
        torch.cuda.synchronize()
        check_state(f"IC {label}", sim.state, cfg.n)
        overflow = int(sim.overflow)
        launched = sorted(k for k, v in launch_counts().items() if v > 0)
        log(f"IC {label}: N={cfg.n}, force {cfg.resolve_force(DEVICE)}, "
            f"softening {cfg.softening}; launched {launched}; overflow "
            f"{overflow}; finite")
        if overflow != 0:
            raise AssertionError(f"IC {label}: overflow {overflow}")
        missing = [k for k in ("near_field", "far_octet")
                   if cfg.force == "barnes_hut" and k not in launched]
        if missing:
            raise AssertionError(f"IC {label}: {missing} not launched")
        del sim


# ----------------------------------------------------------- multi-device
def _nccl_task(group, cfg_json):
    """One rank of a one-rank group: the backend rule's nccl branch, one
    NCCL all_reduce on the card, and dist_bh_accel at a small N."""
    import torch.distributed as dist

    from parallelnbody_tpu_torch.parallel import tasks

    ones = torch.ones(4, device=group.device)
    dist.all_reduce(ones)
    out = tasks.sharded(group, cfg_json, None, "dist_accel")
    acc = out["state"]["acc"]
    return {"backend": group.backend, "all_reduce": float(ones.sum()),
            "overflow": out["overflow"],
            "finite": bool(torch.isfinite(torch.from_numpy(acc)).all())}


def k1_form_work(tgt, n_terms, src_bytes, list_bytes, launches):
    """bound() of K1 over n_terms pair terms, reading the sources, targets
    and lists once and writing `launches` outputs (acc + pot)."""
    n_slice, leaf, _ = tgt.shape
    return bound(n_terms, FLOPS_MONOPOLE, src_bytes + nbytes(tgt) + list_bytes
                 + launches * n_slice * leaf * 16)


def phase_k1_forms(let_json):
    """K1's window and table forms on the card against their plain versions,
    on the lists of rank 0 of examples/barneshut_distributed_let.json (N =
    4M, 8 ranks sharing the card, built by parallel/tasks.owned_geometry):
    the window form on each of the 8 ring windows at the launch shape its
    work picks (each window alone, and the ring evaluation that writes its
    first window and adds the others in place), the table form on the
    assembled LET table and on a table cut to half its rows (lists running
    past it). The ring evaluation (8 window launches) is timed in turns
    against the windows on 8-entry items that each write their output and
    are added by torch, and the table form in the same run, each with its
    bound and share; each launched twice for the same bits."""
    from parallelnbody_tpu_torch.tools import k1_windows

    cfg = SimConfig.from_json(let_json)
    n_ranks = cfg.n_devices
    t0 = time.perf_counter()
    inp = k1_windows.rank0_inputs(cfg, DEVICE)
    tgt, ni, nv = inp["tgt"], inp["ni"], inp["nv"]
    new_idx, table, shards = inp["new_idx"], inp["table"], inp["shards"]
    n_loc, leaf = inp["n_loc"], tgt.shape[1]
    plain = bh_kernels.near_field_plain
    log(f"K1 forms: rank 0 of {n_ranks} at N={cfg.n} ({inp['refine']}, "
        f"{n_loc} owned leaves of {leaf}): near entries a leaf "
        f"{balance(nv.sum(1))}; LET table {table.shape[0] // leaf} rows; "
        f"overflow {inp['overflow']} ({time.perf_counter() - t0:.1f} s)")
    if any(inp["overflow"].values()):
        raise AssertionError("K1 forms: the LET example's lists overflowed")

    works = k1_windows.ring_works(inp, n_ranks)
    shapes = []
    for p, w in enumerate(k1_windows.ring_order(0, n_ranks)):
        wk = works[w]
        lo = torch.sum(nv & (ni < w * n_loc), 1)
        cnt = torch.sum(nv & (ni < (w + 1) * n_loc), 1) - lo
        shapes.append({"window": w, "pass": p, "entries": int(cnt.sum()),
                       "longest": int(cnt.max()), "r": wk.r,
                       "chunk": wk.chunk, "items": int(wk.items.shape[0]),
                       "writes": wk.every_row})
    log("near_field window form, rank 0's ring windows in pass order "
        "(targets a thread r x entries an item, as window_shape picks): "
        + json.dumps(shapes))
    n_out = tgt.shape[0] * leaf

    def zeros():
        return (torch.zeros((n_out, 3), device=DEVICE),
                torch.zeros((n_out,), device=DEVICE))

    rec_w = {"max_abs_err": 0.0, "shapes": shapes}
    for w in range(n_ranks):
        for compute_pot in (False, True):
            out = None if works[w].every_row else zeros()
            err = max_err(f"near_field window {w} pot={compute_pot}",
                          k1_windows.window_call(inp, w, cfg, compute_pot,
                                                 work=works[w], out=out),
                          k1_windows.window_call(inp, w, cfg, compute_pot,
                                                 plain, out=zeros()))
            rec_w["max_abs_err"] = max(rec_w["max_abs_err"], err)
    for compute_pot in (False, True):
        err = max_err(f"near_field ring pot={compute_pot}",
                      k1_windows.ring_eval(inp, works, cfg, compute_pot),
                      k1_windows.ring_eval(inp, None, cfg, compute_pot,
                                           plain))
        rec_w["max_abs_err"] = max(rec_w["max_abs_err"], err)
    rec_w["deterministic"] = repeat_equal(
        "near_field window ring", lambda: k1_windows.ring_eval(inp, works,
                                                               cfg))
    k1_windows.ring_eval(inp, None, cfg, fn=plain)           # warm-up
    _, rec_w["plain_ms"] = cuda_ms(lambda: k1_windows.ring_eval(
        inp, None, cfg, fn=plain))
    # The same windows on 8-entry items at the leaf size's R, each launch
    # writing its own output and torch adding them (the window form before
    # it was shaped by the window's work and accumulated in place).
    written = bh_kernels.near_windows(
        ni, nv, k1_windows.edges(inp, n_ranks),
        chunk=k1_windows.WRITTEN_CHUNK)
    runs = {"shaped": lambda: k1_windows.ring_eval(inp, works, cfg),
            "written": lambda: k1_windows.written_and_added(inp, written,
                                                            cfg)}
    for fn in runs.values():                                 # warm-up
        fn()
    alt = {"shaped": [], "written": []}
    ring_sum = None
    for k in ("written", "shaped", "shaped", "written"):
        out, ms = cuda_ms(runs[k], KERNEL_REPS)
        alt[k].append(ms)
        if k == "shaped":
            ring_sum = out
    rec_w["ms"] = statistics.mean(alt["shaped"])
    rec_w["ms_runs"] = alt["shaped"]
    rec_w["ms_written_8"] = alt["written"]
    with_share(rec_w, k1_form_work(tgt, int(nv.sum()) * leaf * leaf,
                                   sum(nbytes(s) for s in shards),
                                   nbytes(ni, nv), 1))
    log(f"near_field window form, {n_ranks} windows of rank 0's lists "
        f"(compute_pot=False), one ring evaluation, in turns (written, "
        f"shaped, shaped, written): shaped and accumulated "
        + ", ".join(f"{m:.3f}" for m in alt["shaped"]) + " ms; 8-entry "
        "items written and added " + ", ".join(
            f"{m:.3f}" for m in alt["written"]) + f" ms; plain "
        f"{rec_w['plain_ms']:.1f} ms, bound {rec_w['bound_ms']:.3f} ms "
        f"({rec_w['bound_resource']}), share {rec_w['share']:.3f}; max abs "
        f"err {rec_w['max_abs_err']:.3e} (each window and the ring, both "
        "potential settings); repeat launches bit-equal")

    n_rows = table.shape[0] // leaf
    twork = bh_kernels.near_work(nv, new_idx, (0, n_rows))
    rec_t = {"max_abs_err": 0.0}

    def tform(src, fn=bh_kernels.near_field, compute_pot=False, **extra):
        return fn(None, None, tgt, new_idx, nv, compute_pot=compute_pot,
                  src_table=src, g=cfg.g, softening=cfg.softening, **extra)

    # The needed leaves take the first rows of the table (the import budget
    # 0 sizes it for every leaf): cut it at half of them.
    n_needed = int(new_idx[nv].max()) + 1
    n_cut = n_needed // 2
    cut = table[:n_cut * leaf]
    if not bool((nv & (new_idx >= n_cut)).any()):
        raise AssertionError("near_field table: no list runs past the cut")
    for label, src, extra in (("full", table, dict(work=twork)),
                              ("cut to half", cut, {})):
        for compute_pot in (False, True):
            err = max_err(f"near_field table {label} pot={compute_pot}",
                          tform(src, compute_pot=compute_pot, **extra),
                          tform(src, plain, compute_pot=compute_pot))
            rec_t["max_abs_err"] = max(rec_t["max_abs_err"], err)
    rec_t["deterministic"] = repeat_equal(
        "near_field table", lambda: tform(table, work=twork))
    tform(table, plain)                                      # warm-up
    _, rec_t["plain_ms"] = cuda_ms(lambda: tform(table, plain))
    tform(table, work=twork)                                 # warm-up
    let_out, rec_t["ms"] = cuda_ms(lambda: tform(table, work=twork),
                                   KERNEL_REPS)
    live = nv & (new_idx < n_rows)
    with_share(rec_t, k1_form_work(tgt, int(live.sum()) * leaf * leaf,
                                   nbytes(table), nbytes(new_idx, nv), 1))
    err = max_err("ring windows against the LET table form", ring_sum,
                  let_out)
    if not err < 1e-5:
        raise AssertionError(f"near_field: the ring windows differ from the "
                             f"table form by {err:.3e} (limit 1e-5)")
    log(f"near_field table form on rank 0's LET table ({n_rows} rows, "
        f"{n_needed} needed, cut at {n_cut}; "
        f"compute_pot=False): {rec_t['ms']:.3f} ms, plain "
        f"{rec_t['plain_ms']:.1f} ms, bound {rec_t['bound_ms']:.3f} ms "
        f"({rec_t['bound_resource']}), share {rec_t['share']:.3f}; max abs "
        f"err {rec_t['max_abs_err']:.3e} (full and cut table, both potential "
        f"settings); the {n_ranks} windows accumulated against it "
        f"{err:.3e}; repeat launches bit-equal")
    return {"near_field_window": rec_w, "near_field_table": rec_t}


def rank_launches(label, stats, need, ratio):
    """Per-rank launch checks of a multi-rank CLI run: every kernel of
    `need` launched on every rank, and for each (form, per, k) of `ratio`
    form == k * per on every rank (per = one launch an evaluation)."""
    for r, st in enumerate(stats):
        got = st["launches"]
        for name in need:
            if got[name] <= 0:
                raise AssertionError(f"{label}: rank {r}: {name} not "
                                     f"launched ({got})")
        for form, per, k in ratio:
            if got[form] != k * got[per]:
                raise AssertionError(f"{label}: rank {r}: {form} "
                                     f"{got[form]} != {k} x {per} "
                                     f"{got[per]}")


def dist_cli_run(label, config, extra, steps, base):
    """`run` of a multi-device config through cli.main (ranks spawned by
    the CLI), checkpointing the final state under base; returns (summary,
    per-rank stats, final state, cfg, wall s)."""
    from parallelnbody_tpu_torch.parallel import mesh
    from parallelnbody_tpu_torch.utils.io import (latest_checkpoint,
                                                  load_checkpoint)

    ck = os.path.join(base, label.replace(" ", "_"))
    reset_launch_counts()
    out, wall = cli_json(["run", "--config", config, "--device", DEVICE,
                          "--quiet", "--steps", str(steps),
                          "--checkpoint-every", str(steps),
                          "--checkpoint-dir", ck, *extra])
    stats = mesh.LAST_RANK_STATS
    state, cfg = load_checkpoint(latest_checkpoint(ck), DEVICE)
    staged = sum(st["staged_bytes"] for st in stats)
    log(f"{label}: {json.dumps(out)}; {len(stats)} ranks, backend "
        f"{sorted({st['backend'] for st in stats})}; wall {wall:.1f} s "
        f"with set-up, {1e3 * out['wall_s'] / out['steps']:.1f} ms/step in "
        f"the step loop; staged through host memory {staged / 1e6:.1f} MB "
        f"in the command, {staged / 1e6 / out['steps']:.1f} MB a step of "
        "it; launches rank 0 "
        + json.dumps({k: v for k, v in stats[0]["launches"].items() if v}))
    if out["bh_overflow"] != 0 or int(state.step) != steps:
        raise AssertionError(f"{label}: {out}, step {int(state.step)}")
    check_state(label, state, cfg.n)
    return out, stats, state, cfg, wall, staged


def phase_distributed(let_json):
    """Both multi-device examples through cli.main, their ranks sharing the
    card through gloo: the all-pairs mesh (4 ranks, K3 the ring's tile) and
    the LET example (8 ranks) as shipped, then with the ring near field,
    the ring with the gather far field (K4), rebuild 8 over 8 steps and
    the replicated tree on 4 ranks; a one-rank nccl group last."""
    from parallelnbody_tpu_torch.parallel import mesh

    base = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(base, ignore_errors=True)
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    res = {}

    out, stats, state, cfg, wall, staged = dist_cli_run(
        "all-pairs mesh", MESH_CONFIG, [], 1, base)
    evals = 4  # t = 0 forces, the step, two diagnostics' potentials
    rank_launches("all-pairs mesh", stats, ("allpairs",), ())
    for r, st in enumerate(stats):
        if st["launches"]["allpairs"] != cfg.n_devices * evals:
            raise AssertionError(f"all-pairs mesh: rank {r} launched K3 "
                                 f"{st['launches']['allpairs']} times")
    rows = torch.linspace(0, cfg.n - 1, RMS_SAMPLES, device=dev).long()
    tgt = state.pos[rows].contiguous()
    # The ring's forces of the sampled targets are held against the f64
    # direct sum. Single-device K3 on the same targets is a second witness,
    # printed only: with few targets it splits the sources into ranges,
    # while each ring pass sums its 1M sources in one f32 pass, so the two
    # differ by more than reassociation within one sum.
    sampled = direct_kernels.allpairs_accel_tile(
        tgt, state.pos, state.mass, g=cfg.g, softening=cfg.softening)[0]
    ring = state.acc[rows]
    rel = float(torch.linalg.norm(ring - sampled) / torch.linalg.norm(sampled))
    exact = direct_accel_at(state.pos.double(), state.mass.double(),
                            tgt.double(), g=cfg.g, softening=cfg.softening,
                            chunk=8192)
    err_ring, err_sampled = (
        float(torch.linalg.norm(a.double() - exact) / torch.linalg.norm(exact))
        for a in (ring, sampled))
    log(f"all-pairs mesh: K3 {stats[0]['launches']['allpairs']} launches a "
        f"rank ({cfg.n_devices} passes x {evals} evaluations); forces of "
        f"{RMS_SAMPLES} sampled targets against the f64 direct sum: ring "
        f"{err_ring:.3e}, single-device K3 on the same targets "
        f"{err_sampled:.3e}; ring against single-device K3: relative norm "
        f"{rel:.3e}")
    if not err_ring < RMS_BOUND_ALLPAIRS:
        raise AssertionError(f"all-pairs mesh: ring against f64 "
                             f"{err_ring:.3e}")
    res["mesh"] = dict(ms_step=1e3 * out["wall_s"], wall_s=wall,
                       staged=staged, rel=rel,
                       launches=sum(st["launches"]["allpairs"]
                                    for st in stats))
    del state, sampled
    torch.cuda.empty_cache()

    runs = [
        ("LET example", [], 2, ("far_octet", "near_field_table"),
         [("near_field_table", "far_octet", 1), ("near_field", "far_octet",
                                                 0)]),
        ("ring", ["--bh-comm", "ring"], 2,
         ("far_octet", "near_field_window"),
         [("near_field_window", "far_octet", 8)]),
        # The shipped far budget counts octets; the gather far list counts
        # node rows, up to 8 an octet.
        ("ring gather", ["--bh-comm", "ring", "--bh-far-mode", "gather",
                         "--bh-far-budget", str(GATHER_FAR_BUDGET)], 1,
         ("far_gather", "near_field_window"),
         [("near_field_window", "far_gather", 8)]),
        ("LET rebuild 8", ["--bh-rebuild-every", "8", "--log-every", "0"], 8,
         ("far_octet", "near_field_table"),
         [("near_field_table", "far_octet", 1)]),
        ("replicated tree", ["--bh-distributed", "false", "--devices", "4"],
         2, ("far_octet", "near_field"), [("near_field", "far_octet", 1)]),
    ]
    single = None
    for label, extra, steps, need, ratio in runs:
        out, stats, state, cfg, wall, staged = dist_cli_run(
            label, LET_CONFIG, extra, steps, base)
        rank_launches(label, stats, need, ratio)
        rms = rms_force_error_sample(state.pos, state.mass, state.acc,
                                     g=cfg.g, softening=cfg.softening,
                                     k=RMS_SAMPLES)
        # The single-device Barnes-Hut on the same state and targets, at
        # budgets calibrated on it.
        scfg = calibrate_budgets(cfg.replace(mesh_shape=(),
                                             bh_distributed=False,
                                             bh_near_budget=0,
                                             bh_far_budget=0), state)
        sacc, _, sof = bh.bh_accel(
            state.pos, state.mass, leaf_size=scfg.resolve_bh_leaf_size(),
            theta=scfg.theta, g=scfg.g, softening=scfg.softening,
            near_budget=scfg.bh_near_budget, far0_budget=scfg.bh_far_budget,
            curve=scfg.bh_curve, multipole=scfg.bh_multipole,
            max_levels=scfg.bh_max_levels, compute_pot=False,
            refine=scfg.resolve_bh_refine(),
            cand_budgets=(scfg.bh_cand2_budget, scfg.bh_cand_budget))
        single = rms_force_error_sample(state.pos, state.mass, sacc, g=cfg.g,
                                        softening=cfg.softening,
                                        k=RMS_SAMPLES)
        del sacc
        log(f"{label}: rms force error vs direct sum (k={RMS_SAMPLES}) "
            f"{rms:.4e}; single-device bh_accel on the same state "
            f"{single:.4e} (overflow {int(sof)})")
        if not (rms < RMS_BOUND and rms <= 1.5 * single + 1e-3
                and int(sof) == 0):
            raise AssertionError(f"{label}: rms {rms:.4e}, single "
                                 f"{single:.4e}, overflow {int(sof)}")
        res[label] = dict(ms_step=1e3 * out["wall_s"] / out["steps"],
                          wall_s=wall, staged_step=staged / out["steps"],
                          rms=rms, rms_single=single,
                          backend=stats[0]["backend"],
                          launches={k: sum(st["launches"][k] for st in stats)
                                    for k in ("near_field",
                                              "near_field_window",
                                              "near_field_table",
                                              "far_octet", "far_gather")})
        del state
        torch.cuda.empty_cache()

    small = SimConfig(n=8192, ic="plummer", force="barnes_hut",
                      bh_leaf_size=64, bh_distributed=True,
                      bh_near_budget=256, bh_far_budget=512)
    got = mesh.launch(_nccl_task, 1, small.to_json(), device=DEVICE,
                      timeout=300)[0]
    log(f"one-rank group on {DEVICE}: {json.dumps(got)}")
    if got != {"backend": "nccl", "all_reduce": 4.0, "overflow": 0,
               "finite": True}:
        raise AssertionError(f"nccl rank: {got}")
    return res

# ------------------------------------------------- K8-K11 (experiments)
def rows_close(name, got, want):
    """measure.rows_close at RTOL / ATOL: within ATOL + RTOL of each target
    row's largest |value|, as the scripts' random sources cancel some sums
    to near zero."""
    torch.cuda.synchronize()
    return measure.rows_close(name, got, want, RTOL, ATOL)


def _scripts_check_inputs(dev):
    """The scripts' check inputs (tools/flat_kernel.py), masses made
    positive: [(label, packs, (rows, tgt_t, src))]."""
    import numpy as np

    cases = [("proto check", 4, flat_kernel.proto_check_inputs(dev))]
    for packs, fa in flat_kernel.tune2_check_inputs(
            np.random.default_rng(0), dev):
        fa[2][:, :, 3].abs_()
        cases.append((f"tune2 check P={packs}", packs, fa))
    return cases


def _flat_variants(packs):
    """(kernel, variant, wrapper, plain, keywords) of K9-K11 at packs."""
    out = [("flat_near", "", near_flat.flat_near, near_flat.flat_near_plain,
            {})] if packs == near_flat.PROTO_PACKS else []
    out += [("flat_tune", m, near_flat.flat_tune, near_flat.flat_tune_plain,
             {"step_packs": packs, "out_mode": m})
            for m in near_flat.OUT_MODES]
    out += [("flat_tune2", m, near_flat.flat_tune2,
             near_flat.flat_tune2_plain, {"step_packs": packs, "mode": m})
            for m in near_flat.LANE_MODES]
    return out


def phase_near_experiments():
    """K8 (near_probe) and K9-K11 (flat_near, flat_tune, flat_tune2), the
    near-field experiments of four TPU scripts. Each instantiation against
    its plain version and launched twice for the same bits: K8's modes,
    unrolls and strides on the N = 65536 leaf-256 lists (4 segments, and A
    in one); K9-K11 on those lists' flat form (each step size, both output
    modes, with and without the potential) and at the scripts' check sizes
    (the row-scale bound of rows_close; K11's two modes within the script's
    1e-3). Then, with every launch count set to 0 before and read after,
    the tools' tables: near_kernel_probe and flat_kernel lists on the N = 1M
    lists (every row that computes K1's function held to K1), flat_kernel
    proto, tune and tune2 at the scripts' sizes, each bench launch held to
    its plain version on sampled rows); each of K8-K11 must launch. Last,
    at N = 1M, each kernel's headline row and K8's B and C against their
    plain versions, which are timed. Returns {kernel: numbers,
    launches}."""
    dev = torch.device(DEVICE)
    out = {name: {"max_abs_err": 0.0, "deterministic": True}
           for name in EXP_KERNELS}

    def held(name, label, call, plain, rows_scale=False):
        got = call()
        err = (rows_close(f"{name} {label}", got, plain()) if rows_scale
               else max_err(f"{name} {label}", (got,), (plain(),)))
        repeat_equal(f"{name} {label}", lambda: (call(),))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        log(f"{name} {label}: max abs err {err:.3e}; repeat bit-equal")
        return got

    L = near_kernel_probe.probe_lists(EXP_PARITY_N, dev)
    n_leaves = L["tgt_t"].shape[0]
    args = (L["tgt_t"], L["table"], L["idx"], L["valid"])
    for mode in near_probe.MODES:
        for unroll in near_probe.UNROLLS:
            for n_comp in near_probe.N_COMPS:
                for seg in ((4, 1) if (mode, unroll, n_comp) == ("A", 4, 4)
                            else (4,)):
                    kw = dict(mode=mode, unroll=unroll, n_comp=n_comp,
                              rows_per_seg=n_leaves // seg)
                    held("near_probe", f"N={EXP_PARITY_N} {kw}",
                         lambda: near_probe.near_probe(*args, **kw),
                         lambda: near_probe.near_probe_plain(*args, **kw))
    for packs in near_flat.STEP_PACKS:
        rows, src, _, _ = near_flat.pack_lists(
            L["table"].transpose(1, 2), L["idx"], L["valid"], packs)
        fa = (rows, L["tgt_t"], src)
        for name, variant, fn, plain, kw in _flat_variants(packs):
            for pot in (True, False):
                kw2 = dict(kw, compute_pot=pot, eps2=1e-4)
                held(name, f"N={EXP_PARITY_N} lists P={packs} {variant} "
                     f"pot={pot}", lambda: fn(*fa, **kw2),
                     lambda: plain(*fa, **kw2))
        del rows, src, fa
    for label, packs, fa in _scripts_check_inputs(dev):
        if packs == near_flat.PROTO_PACKS and label == "proto check":
            for gz in (False, True):
                for pot in (True, False):
                    kw = dict(eps2=0.0 if gz else 1e-2, guard_zero=gz,
                              compute_pot=pot)
                    held("flat_near", f"{label} {kw}",
                         lambda: near_flat.flat_near(*fa, **kw),
                         lambda: near_flat.flat_near_plain(*fa, **kw), True)
            continue
        lanes = {}
        for name, variant, fn, plain, kw in _flat_variants(packs):
            if name == "flat_near":
                continue
            got = held(name, f"{label} {variant}", lambda: fn(*fa, **kw),
                       lambda: plain(*fa, **kw), True)
            lanes[variant] = got
        diff = float((lanes["step"] - lanes["row"]).abs().max())
        if not diff < 1e-3:
            raise AssertionError(f"{label}: K11 step vs row {diff:.3e}")
    del L, args
    torch.cuda.empty_cache()

    L1 = near_kernel_probe.probe_lists(near_kernel_probe.N, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    table = near_kernel_probe.table(iters=EXP_ITERS, lists=L1)
    table += flat_kernel.lists(iters=EXP_ITERS, L=L1)
    for sub in ("proto", "tune", "tune2"):
        table += flat_kernel.SUBCOMMANDS[sub](EXP_ITERS)
    launches = launch_counts()
    log(f"experiment tables ({time.perf_counter() - t0:.1f} s): launches "
        f"{json.dumps({k: launches[k] for k in EXP_KERNELS})}")
    rows = {(r.get("kernel", "near_probe"), r.get("sub"), r["variant"]): r
            for r in table if "ms" in r and "variant" in r
            and r["variant"] != "K1 near_field"}
    for name in EXP_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"experiment tables: {name} not launched")
        sub = None if name == "near_probe" else "lists"
        head = rows[(name, sub, EXP_HEADLINE[name])]
        rec = out[name]
        rec.update({k: head[k] for k in ("ms", "bound_ms", "bound_by",
                                         "bound_resource", "share",
                                         "pairs")})
        rec["launches"] = launches[name]
        rec["headline"] = EXP_HEADLINE[name]
        rec["k1_ms"] = head["k1_ms"]
        rec["max_abs_err_vs_k1"] = max(
            r["max_abs_err_vs_k1"] for k, r in rows.items()
            if k[0] == name and r.get("max_abs_err_vs_k1") is not None)
        rec["max_abs_err"] = max(
            [rec["max_abs_err"]] + [r["max_abs_err_vs_plain"]
                                    for k, r in rows.items() if k[0] == name
                                    and "max_abs_err_vs_plain" in r])
        rec["variants_ms"] = {f"{k[1] or 'probe'} {k[2]}": r["ms"]
                              for k, r in rows.items() if k[0] == name}
    del table

    # At N = 1M: the headline launch of each kernel, and K8's B and C
    # (checked against nothing else there), against the plain version.
    a1 = (L1["tgt_t"], L1["table"], L1["idx"], L1["valid"])
    for mode in ("A", "B", "C"):
        kw = dict(mode=mode, unroll=4, rows_per_seg=a1[0].shape[0] // 4)
        want, plain_ms = cuda_ms(lambda: near_probe.near_probe_plain(*a1,
                                                                     **kw))
        err = max_err(f"near_probe N = 1M {mode} u4",
                      (near_probe.near_probe(*a1, **kw),), (want,))
        out["near_probe"]["max_abs_err"] = max(
            out["near_probe"]["max_abs_err"], err)
        if mode == "A":
            out["near_probe"]["plain_ms"] = plain_ms
        log(f"near_probe N = 1M {mode} u4 against its plain version: max abs "
            f"err {err:.3e}; plain {plain_ms:.1f} ms")
        del want
    eps2 = near_kernel_probe.SOFTENING ** 2
    for name in EXP_KERNELS[1:]:
        packs = int(EXP_HEADLINE[name].split()[0][2:])
        rows_, src, _, _ = near_flat.pack_lists(
            L1["table"].transpose(1, 2), L1["idx"], L1["valid"], packs)
        (_, _, fn, plain, kw), = [
            v for v in _flat_variants(packs)
            if v[0] == name and (v[1] in EXP_HEADLINE[name] or not v[1])]
        fa = (rows_, L1["tgt_t"], src)
        want, out[name]["plain_ms"] = cuda_ms(
            lambda: plain(*fa, eps2=eps2, **kw))
        err = max_err(f"{name} N = 1M {EXP_HEADLINE[name]}",
                      (fn(*fa, eps2=eps2, **kw),), (want,))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        log(f"{name} N = 1M {EXP_HEADLINE[name]} against its plain version: "
            f"max abs err {err:.3e}")
        del rows_, src, fa, want
    for name in EXP_KERNELS:
        rec = out[name]
        log(f"{name} ({rec['headline']}, N = 1M lists): {rec['ms']:.3f} ms, "
            f"bound {rec['bound_ms']:.3f} ms, share {rec['share']:.3f}; K1 "
            f"{rec['k1_ms']:.3f} ms; plain {rec['plain_ms']:.1f} ms; "
            f"launches {rec['launches']}; max abs err vs plain "
            f"{rec['max_abs_err']:.3e}, vs K1 {rec['max_abs_err_vs_k1']:.3e}")
    del L1, a1
    torch.cuda.empty_cache()
    return out

# ------------------------------------- per-phase geometry tools (phase 18)
def run_tool(label, fn, need, log_path=None, whole=True):
    """fn() (a tool's main) with its JSON lines kept in log_path (default
    TOOLS_LOG) instead of standard output, every launch count set to 0 just
    before and read just after; fails unless each kernel of `need` was
    launched, or (whole) where a busy reading was not whole. Returns
    (records, launches)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    with open(log_path or TOOLS_LOG, "a") as f:
        f.write(buf.getvalue())
    log(f"{label}: {time.perf_counter() - t0:.1f} s, {len(records)} lines; "
        f"launches {json.dumps(launches)}")
    for name in need:
        if not launches.get(name):
            raise AssertionError(f"{label}: {name} was not launched")
    lost = [r.get("phase") or r.get("stage") or r.get("theta")
            or r.get("name") for r in records
            if "busy_ms" in r and r["busy_ms"] is None]
    if lost and not whole:
        log(f"{label}: busy not measured (no whole profiler reading in "
            f"{measure.BUSY_TRIES} tries) for {lost}")
    elif lost:
        raise AssertionError(f"{label}: no whole profiler reading in "
                             f"{measure.BUSY_TRIES} tries for {lost}")
    return records, launches


def _ms(v):
    return "n/a" if v is None else f"{v:.3f}"


def phase_table(label, records):
    """Logs bh_breakdown's phases (events ms, busy ms, busy share) and its
    composed rows; returns its summary."""
    for r in records:
        if "phase" in r:
            stats = {k: r[k] for k in ("overflow", "n_leaves", "items")
                     if k in r}
            work = (f"; {r['pairs']:.4e} terms, bound {r['bound_ms']:.3f} ms"
                    if "pairs" in r else "")
            log(f"  {label} {r['phase']:<32} events {_ms(r['ms'])} ms, busy "
                f"{_ms(r['busy_ms'])} ms, share {_ms(r['busy_share'])}"
                f"{work} {json.dumps(stats) if stats else ''}")
    s = records[-1]
    log(f"  {label} per step {_ms(s['per_step_ms'])} ms (busy "
        f"{_ms(s['per_step_busy_ms'])}); rebuild {s.get('rebuild')} "
        f"{_ms(s.get('rebuild_ms'))} ms/step (busy "
        f"{_ms(s.get('rebuild_busy_ms'))}); bh_accel "
        f"{_ms(s['bh_accel_ms'])} ms (busy {_ms(s['bh_accel_busy_ms'])}); "
        f"composed - bh_accel max abs {s['max_abs_diff']:.3e}; overflow "
        f"{s['overflow']}; peak {_ms(s.get('peak_gib'))} GiB")
    return s


def phase_geometry_tools():
    """Phase 18 in a process of its own (this script with
    GEOMETRY_TOOLS_ARG), which prints its lines here: by the time the
    earlier phases have run, this process's torch.profiler loses CUDA
    activity records, and the tools' busy readings would not be whole.
    Fails where the child does. Returns {tool: launches}, the child's."""
    torch.cuda.empty_cache()
    out = os.path.join(ROOT, "build", "chip_smoke_tools_launches.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         GEOMETRY_TOOLS_ARG, out], timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 18 (geometry tools) exited {rc}")
    with open(out) as f:
        return json.load(f)


def geometry_tools():
    """The per-phase Barnes-Hut tools (tools/bh_breakdown.py, li_profile,
    staged_probe, octet_probe, reuse_probe, theta_sweep) on the card, each
    with the launch counts set to 0 before and read after. Fails where the
    composed phases differ from bh_accel beyond rtol 2e-4 / atol 2e-5 (the
    tool raises), a calibrated row overflows, a tool does not launch the
    kernels it runs, or a busy reading is not whole in measure.BUSY_TRIES
    tries. First reads the 1M per-step busy share of
    examples/barneshut_1m_reuse.json afresh. Returns {tool: launches}."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(TOOLS_LOG), exist_ok=True)
    with open(TOOLS_LOG, "w"):
        pass
    with open(CONFIG) as f:
        sim = Simulation(SimConfig.from_json(f.read()), device=DEVICE)
    sim.step(1)
    _, ms_step = cuda_ms(lambda: sim.step(1), STEP_REPS)
    dev_step = measure.busy_ms(lambda: sim.step(1))
    if dev_step is None:
        raise AssertionError("1M step(1): no whole profiler reading in "
                             f"{measure.BUSY_TRIES} tries")
    log(f"1M octet path in a fresh process: per-step {ms_step:.2f} ms "
        f"(mean of {STEP_REPS} step(1)); device busy {dev_step:.2f} ms "
        f"(share {busy_share(dev_step, ms_step)}, a whole reading)")
    del sim
    torch.cuda.empty_cache()
    it = ["--iters", str(TOOL_ITERS)]
    runs = {}

    def go(label, fn, need):
        records, runs[label] = run_tool(label, fn, need)
        return records

    rec = go("bh_breakdown gather 1M", lambda: bh_breakdown.main(it),
             ("near_field", "far_gather"))
    phase_table("gather 1M", rec)
    for label, path, refine in (("octet 1M", CONFIG, "dense"),
                                ("staged 8M", STAGED_CONFIG, "staged")):
        rec = go(f"bh_breakdown {label}", lambda: bh_breakdown.main(
            it + ["--config", path, "--rebuild", "8"]),
            ("near_field", "far_octet"))
        s = phase_table(label, rec)
        if s["overflow"] or s["refine"] != refine:
            raise AssertionError(f"bh_breakdown {label}: overflow "
                                 f"{s['overflow']}, refine {s['refine']}")
    rec = go("li_profile", lambda: li_profile.main(it), ())
    stages = {r["stage"]: [_ms(r["ms"]), _ms(r["busy_ms"])]
              for r in rec if "stage" in r}
    log(f"  li_profile (events, busy ms): {json.dumps(stages)}; " + json.dumps(
        {k: rec[-1][k] for k in ("a_to_e_ms", "l1_overflow", "overflow",
                                 "lists_equal")}))
    rec = go("staged_probe phases", lambda: staged_probe.main(
        it + ["--mode", "phases"]), ("near_field", "far_gather"))
    log("  staged_probe: " + json.dumps(
        {r["phase"]: [_ms(r["ms"]), _ms(r["busy_ms"])] for r in rec}))
    for label, argv in (("octet_probe 8m", ["--set", "8m"]),
                        ("octet_probe probe quick", ["--quick"])):
        rec = go(label, lambda: octet_probe.main(argv),
                 ("near_field", "far_octet", "far_gather"))
        for r in rec:
            log(f"  {label} leaf {r['leaf']} {r['refine']} {r['far_mode']}: "
                f"{_ms(r['ms'])} ms (busy {_ms(r['busy_ms'])}), overflow "
                f"{r['overflow']}, {r['far_kernel']} terms "
                f"{r['far_terms']:.4e}, near pairs {r['near_pairs']:.4e}")
    rec = go("reuse_probe 1M", lambda: reuse_probe.main(
        it + ["--k", str(REUSE_STEPS)]), ("near_field", "far_octet"))
    for r in rec:
        log("  reuse_probe " + json.dumps({k: v for k, v in r.items()
                                           if k not in ("tool", "card")}))
    rec = go("theta_sweep", lambda: theta_sweep.main(it),
             ("near_field", "far_octet", "allpairs"))
    for r in rec:
        log(f"  theta_sweep theta {r['theta']}: rms {r['rms_err']:.3e} "
            f"(overflow {r['overflow_rms']}), 1M {_ms(r['ms'])} ms (busy "
            f"{_ms(r['busy_ms'])}), overflow {r['overflow']}")
    log("geometry tools busy readings: " + json.dumps(measure.READINGS))
    log(f"geometry tools wall time {time.perf_counter() - t0:.1f} s "
        f"(lines in {TOOLS_LOG})")
    return runs


# ------------------------------- the benchmark suite and probes (phase 19)
def phase_port_tools():
    """Phase 19 in a process of its own (this script with PORT_TOOLS_ARG),
    which prints its lines here: the tools' busy readings need a fresh
    process's profiler, as phase 18's do. Fails where the child does.
    Returns {tool: launches}, the child's (this process's counts; the
    ranks' are in the tools' records)."""
    torch.cuda.empty_cache()
    out = os.path.join(ROOT, "build", "chip_smoke_port_tools_launches.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         PORT_TOOLS_ARG, out], timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 19 (port tools) exited {rc}")
    with open(out) as f:
        return json.load(f)


def _need(label, launches, names):
    missing = [k for k in names if not launches.get(k)]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched ({launches})")


def check_bench_rows(rows):
    """Every row of the suite: K1 and K2 launched in a Barnes-Hut row's
    timed steps, K3 in an all-pairs row's; no clip and the rms class on
    the Barnes-Hut rows (an error row already made the tool exit)."""
    for r in rows:
        bh_row = r["force"] == "barnes_hut"
        _need(r["name"], r["launches"], ("near_field", "far_octet")
              if bh_row else ("allpairs",))
        if bh_row and (r["overflow"] or not r["rms_force_error"] < RMS_BOUND):
            raise AssertionError(f"{r['name']}: overflow {r['overflow']}, "
                                 f"rms {r['rms_force_error']:.3e}")
        log(f"  {r['name']}: {r['ms_per_step']:.3f} ms/step (events "
            f"{_ms(r['events_ms_per_step'])}, busy share "
            f"{_ms(r.get('busy_share'))}), rms "
            f"{_ms(r.get('rms_force_error'))}, overflow {r.get('overflow')}, "
            f"peak {_ms(r['peak_gib'])} GiB, init+first "
            f"{r['init_plus_first_s']:.1f} s, {json.dumps(r['launches'])}")


def check_dist(comm, rec):
    """A distributed run: nothing clipped, K2 and K1's form for the comm
    launched on rank 0."""
    form = "near_field_window" if comm == "ring" else "near_field_table"
    _need(f"{comm} run", rec["launches_rank0"], (form, "far_octet"))
    if rec["overflow"]:
        raise AssertionError(f"{comm} run: overflow {rec['overflow']}")


def port_tools():
    """The benchmark suite, the sections probe, the three multi-rank
    probes on DIST_RANKS ranks sharing the card and the two LET geometry
    probes, at the tools' sizes but PORT_TOOLS_CUTS, each with the launch
    counts set to 0 before and read after, their JSON lines in
    PORT_TOOLS_LOG. Returns {tool: launches}."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(PORT_TOOLS_LOG), exist_ok=True)
    with open(PORT_TOOLS_LOG, "w"):
        pass
    runs, seconds = {}, {}
    dev = torch.device(DEVICE)

    def go(label, fn, need=()):
        t = time.perf_counter()
        records, runs[label] = run_tool(label, fn, need, PORT_TOOLS_LOG,
                                        whole=False)
        seconds[label] = time.perf_counter() - t
        return records

    rows = go("bench_suite", lambda: bench_suite.main(
        ["--out", PORT_TOOLS_BENCH]), ("near_field", "far_octet",
                                       "allpairs"))
    check_bench_rows(rows)
    rows = go("sections_probe", lambda: sections_probe.main([]),
              ("near_field", "far_octet"))
    for r in rows:
        if r["oom"]:
            raise AssertionError(f"sections_probe: out of memory at {r}")
        log(f"  sections {r['sections']} (resolved {r['resolved']}): "
            f"{_ms(r['ms'])} ms an evaluation, overflow {r['overflow']}, "
            f"peak {_ms(r['peak_gib'])} GiB, bit-equal to sections "
            f"{r['bit_equal_to']}")
    with RankPool(DIST_RANKS, dev) as pool:
        recs = go("dist_collectives_probe", lambda: (
            dist_collectives_probe.probe(
                pool, COLLECTIVES_N, 16, 8, ["ring", "let"], dev,
                near=COLLECTIVES_BUDGETS[0], far=COLLECTIVES_BUDGETS[1])))
        for r in recs[:-1]:
            check_dist(r["comm"], r)
            log(f"  collectives {r['comm']} {r['run']}: "
                f"{json.dumps(r['counts'])} = {r['total']} "
                f"(JAX's calls for the same structure: "
                f"{r['jax_equivalent_total']}); structure "
                f"{json.dumps(r['structure'])}")
        log(f"  collectives reduction: {json.dumps(recs[-1]['reduction'])}")
        cfg = dist_production_probe.make_cfg(PRODUCTION_N, 128,
                                             *PRODUCTION_BUDGETS, 8)
        rep = go("dist_production_probe", lambda: [
            dist_production_probe.probe(pool, cfg, 16, dev)])[0]
        for comm in ("ring", "let"):
            check_dist(comm, rep[comm])
            if not rep[comm]["rms_force_error"] < RMS_BOUND:
                raise AssertionError(f"dist_production {comm}: rms "
                                     f"{rep[comm]['rms_force_error']:.3e}")
        if rep["per_step"]["overflow"]:
            raise AssertionError(f"dist_production per step: overflow "
                                 f"{rep['per_step']['overflow']}")
        log("  dist_production: " + json.dumps(
            {c: {k: rep[c][k] for k in ("overflow", "wall_s",
                                        "rms_force_error", "steps_done")}
             for c in ("ring", "let")})
            + f"; ring - LET max |dpos| {rep['ring_vs_let_max_pos_diff']:.3e}"
            f"; migrants {rep['per_step']['migrants_entry']} then "
            f"{rep['per_step']['migrants_series']}")
        recs = go("exchange_volume_probe", lambda: [
            exchange_volume_probe.run_case(pool, name, c, EXCHANGE_STEPS, dev)
            for name, c in exchange_volume_probe.cases(
                EXCHANGE_N, 0.004, 0.9, 1.0, 4.0)])
        for r in recs:
            check_dist("ring", r)
            log(f"  exchange {r['case']}: entry "
                f"{r['entry_exchange_frac']:.4f}, steady mean "
                f"{r['steady_mean_frac']:.5f} p90 {r['steady_p90_frac']:.5f}"
                f" max {r['steady_max_frac']:.5f}")
    for label, tool in (("let_halo_probe", let_halo_probe),
                        ("let_granularity_probe", let_granularity_probe)):
        for r in go(label, lambda: tool.main([])):
            log(f"  {label}: " + json.dumps(
                {k: v for k, v in r.items()
                 if k not in ("tool", "card", "per_rank")}))
    log("phase 19: " + json.dumps({"cuts": PORT_TOOLS_CUTS,
                                   "seconds": seconds,
                                   "launches": runs}))
    log(f"port tools wall time {time.perf_counter() - t0:.1f} s (lines in "
        f"{PORT_TOOLS_LOG}, table in {PORT_TOOLS_BENCH})")
    return runs


# ----------------------- the list-statistics and MAC probes (phase 20)
def phase_stat_tools():
    """Phase 20 in a process of its own (this script with STAT_TOOLS_ARG),
    which prints its lines here, as phases 18 and 19 do. Fails where the
    child does. Returns {tool: launches}, the child's (this process's
    counts; the ranks' are checked in the child)."""
    torch.cuda.empty_cache()
    out = os.path.join(ROOT, "build", "chip_smoke_stat_tools_launches.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         STAT_TOOLS_ARG, out], timeout=600).returncode
    if rc != 0:
        raise AssertionError(f"phase 20 (stat tools) exited {rc}")
    with open(out) as f:
        return json.load(f)


def _held(label, rec, key, names=None):
    """A record's max abs error against the plain version(s) (`key`, a
    number or {kernel: number}): present and finite, else fail."""
    v = rec.get(key)
    vals = [v] if names is None else [(v or {}).get(k) for k in names]
    if any(x is None or not math.isfinite(x) for x in vals):
        raise AssertionError(f"{label}: {key} not held ({v})")
    return v


def owned_layout(pos, mass, n_ranks, per_rank, leaf):
    """Particles in curve order cut into n_ranks equal ranges, each padded
    with zero-mass sentinel rows to per_rank leaves (the owned layout of a
    distributed tree): (pos_s, mass_s, sentinel)."""
    center, half, sentinel = bh.domain_cube(torch.amin(pos, 0),
                                            torch.amax(pos, 0))
    order = torch.sort(bh.hilbert_encode(pos, center, half),
                       stable=True).indices
    n_local, cap = pos.shape[0] // n_ranks, per_rank * leaf
    pos_s = sentinel.repeat(n_ranks * cap, 1)
    mass_s = mass.new_zeros(n_ranks * cap)
    for k in range(n_ranks):
        rows = order[k * n_local:(k + 1) * n_local]
        pos_s[k * cap:k * cap + n_local] = pos[rows]
        mass_s[k * cap:k * cap + n_local] = mass[rows]
    return pos_s, mass_s, sentinel


def wide_parent_check(dev):
    """The repaired staged octet keys on the card: the 4 x 40-leaf tree,
    first in one process (K2 on its staged octet lists, which must hold
    keys past the root's first octet, against the plain version, and K2's
    forces against K4's on the gather form of the same lists), then through dist_bh_accel on WIDE_RANKS ranks sharing the
    card, octet against gather (< GATHER_OCTET_BOUND relative) and both
    against K3's direct sum (< RMS_BOUND). Returns its record."""
    from parallelnbody_tpu_torch.parallel import mesh, tasks
    from parallelnbody_tpu_torch.parallel.distributed import _plan

    cfg = SimConfig(n=WIDE_N, ic="plummer", seed=WIDE_SEED,
                    softening=0.02, dt=1e-3,
                    force="barnes_hut", bh_leaf_size=WIDE_LEAF,
                    bh_near_budget=256, bh_distributed=True,
                    bh_refine="staged", bh_rebuild_every=1, theta=0.72)
    state = init_simulation(cfg, "cpu", compute_forces=False)
    per_rank = _plan(WIDE_N // WIDE_RANKS, WIDE_RANKS, WIDE_LEAF)[2]
    pos_s, mass_s, sentinel = owned_layout(
        state.pos.to(dev), state.mass.to(dev), WIDE_RANKS, per_rank,
        WIDE_LEAF)
    tree = bh.build_tree(pos_s, mass_s, WIDE_LEAF, sentinel,
                         multipole_order=2)
    widths = [c.shape[0] for c in tree.com]
    if widths != [WIDE_RANKS * per_rank, WIDE_RANKS * per_rank // 8, 1]:
        raise AssertionError(f"wide parent: levels {widths}")
    n_leaves = widths[0]
    fm, rej = bh.traverse(tree, cfg.theta, stop_level=2)
    _, cands = bh.resolve_refine("staged", (0, 0), 3, n_leaves, n_leaves)
    kw = dict(theta=cfg.theta, start_leaf=0, n_slice=n_leaves,
              near_budget=n_leaves, far_budget=4 * n_leaves,
              cand2_budget=cands[0], cand1_budget=cands[1],
              dtype=torch.float32)
    _, _, fk, fv, nodes8, of = bh.build_interaction_lists_staged(
        tree, fm, rej, octet_far=True, **kw)
    _, _, gi, gv, nodes_all, of_g = bh.build_interaction_lists_staged(
        tree, fm, rej, **kw)
    tgt = pos_s.reshape(n_leaves, WIDE_LEAF, 3)
    fkw = dict(g=1.0, softening=cfg.softening, compute_pot=False)
    reset_launch_counts()
    k2, _ = bh_kernels.far_octet(tgt, nodes8, fk, fv, **fkw)
    k4, _ = bh_kernels.far_gather(tgt, nodes_all, gi, gv, **fkw)
    if launch_counts()["far_octet"] != 1 or int(of) or int(of_g):
        raise AssertionError(f"wide parent: K2 launches "
                             f"{launch_counts()['far_octet']}, overflow "
                             f"{int(of)} / {int(of_g)}")
    err = measure.max_abs_err(
        "K2 on the wide parent's staged octet lists", k2,
        bh_kernels.far_octet_plain(tgt, nodes8, fk, fv, **fkw)[0], RTOL,
        ATOL)
    rel_lists = float(torch.linalg.norm(k2 - k4) / torch.linalg.norm(k4))
    offs8 = bh._octet_offsets(widths)[0]
    octs = fk[fv] >> 8
    past_first = int(torch.sum((octs > offs8[1]) & (octs < offs8[2])))
    arrays = {k: getattr(state, k).numpy() for k in ("pos", "vel", "mass")}
    accs = {}
    with RankPool(WIDE_RANKS, dev) as pool:
        for far_mode, kern in (("octet", "far_octet"),
                               ("gather", "far_gather")):
            outs = pool.run(tasks.sharded, cfg.replace(
                bh_far_mode=far_mode).to_json(), arrays, "dist_accel")
            rank_launches(f"wide parent {far_mode}", mesh.LAST_RANK_STATS,
                          (kern, "near_field_window"), ())
            if outs[0]["overflow"]:
                raise AssertionError(f"wide parent {far_mode}: overflow "
                                     f"{outs[0]['overflow']}")
            accs[far_mode] = torch.cat([torch.from_numpy(o["state"]["acc"])
                                        for o in outs])
    rel = float(torch.linalg.norm(accs["octet"] - accs["gather"])
                / torch.linalg.norm(accs["gather"]))
    ref, _ = direct_kernels.allpairs_accel_tile(
        state.pos.to(dev), state.pos.to(dev), state.mass.to(dev), g=1.0,
        softening=cfg.softening, compute_pot=False)
    ref = ref.cpu()
    rms = {m: float(torch.sqrt(torch.mean(torch.sum((a - ref) ** 2, 1)))
                    / torch.sqrt(torch.mean(torch.sum(ref ** 2, 1))))
           for m, a in accs.items()}
    rec = {"levels": widths, "k2_max_abs_err": err,
           "k2_vs_k4_same_lists": rel_lists,
           "octet_keys_past_first_octet": past_first,
           "ranks_octet_vs_gather": rel, "rms": rms}
    if not (past_first and rel_lists < GATHER_OCTET_BOUND
            and rel < GATHER_OCTET_BOUND and max(rms.values()) < RMS_BOUND):
        raise AssertionError(f"wide parent: {rec}")
    return rec


def stat_tools():
    """The six list-statistics and MAC tools at their defaults but
    STAT_TOOLS_CUTS, each with the launch counts set to 0 before and read
    after, their JSON lines in STAT_TOOLS_LOG; then the repaired staged
    octet keys (`wide_parent_check`). Fails where a tool does not launch
    the kernels it runs, a launch is not held to its plain version, an
    rms is not finite, or the geometric MAC leaves the rms class. Returns
    {tool: launches}."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(STAT_TOOLS_LOG), exist_ok=True)
    with open(STAT_TOOLS_LOG, "w"):
        pass
    runs, seconds = {}, {}
    it = ["--iters", str(STAT_ITERS)]

    def go(label, fn, need=()):
        t = time.perf_counter()
        records, runs[label] = run_tool(label, fn, need, STAT_TOOLS_LOG,
                                        whole=False)
        seconds[label] = time.perf_counter() - t
        return records

    rec = go("near_octet_stats", lambda: near_octet_stats.main(it))[-1]
    log("  near_octet_stats: " + json.dumps(
        {k: rec[k] for k in ("n_leaves", "overflow", "near_count",
                             "octets_per_target", "mask_fill",
                             "pair_mult_if_octet")}))
    recs = go("near_refine_probe", lambda: near_refine_probe.main(it),
              ("near_field",))
    _held("near_refine_probe K1", recs[0], "k1_max_abs_err")
    log(f"  near_refine_probe: K1 {recs[0]['k1_ms']:.3f} ms, "
        f"{recs[0]['k1_pairs_per_s']:.4e} pair terms/s (share "
        f"{recs[0]['k1_share']:.3f}); leaf radius "
        + json.dumps(recs[0]["leaf_radius"]))
    for r in recs[1:]:
        log(f"  sub {r['sub']}: near leaves {r['near_leaf_entries']} "
            f"({r['ms_eq_cur']:.2f} ms-eq), refined subs "
            f"{r['refined_subs']} ({r['ms_eq_ref']:.2f} ms-eq, reduction "
            f"{r['reduction']:.2f}x), full {r['full_share']:.3f}, "
            f"lane-padded {r['ms_eq_eff']:.2f} ms-eq"
            + (f"; fattest {json.dumps(r['fattest'])}" if "fattest" in r
               else ""))
    recs = go("cell_leaves_probe", lambda: cell_leaves_probe.main(it),
              ("near_field", "flat_tune2"))
    _held("cell_leaves_probe K1", recs[0], "k1_max_abs_err")
    _held("cell_leaves_probe K11", recs[0], "k11_max_abs_err")
    log(f"  cell_leaves_probe: K1 {recs[0]['k1_pairs_per_s']:.4e} pair "
        f"terms/s, K11 row {recs[0]['k11_pairs_per_s']:.4e} pairs/s "
        f"({recs[0]['k11_ms']:.3f} ms, padding "
        f"{recs[0]['k11_padding_share']:.3f})")
    for r in recs[1:]:
        log(f"  {r['structure']}: {r['n_leaves']} leaves, near/target "
            f"{json.dumps(r['near_per_target'])}, tiles {r['tiles']} "
            f"({r['padded_ms']:.2f} ms at K1), true pairs "
            f"{r['true_pairs']:.4e} ({r['true_ms']:.2f} ms at K11 row)")
    recs = go("mac_experiment", lambda: mac_experiment.main(it),
              ("near_field", "far_gather", "allpairs"))
    for r in recs:
        _held(f"mac_experiment {r['mode']} {r['k']}", r, "max_abs_err_plain")
        if not all(math.isfinite(r[k]) for k in ("rms", "p999", "max")) or (
                r["mode"] == "geom" and not r["rms"] < RMS_BOUND):
            raise AssertionError(f"mac_experiment: {r}")
        log(f"  mac {r['mode']} k={r['k']}: 262k rms {r['rms']:.3e} p999 "
            f"{r['p999']:.3e} max {r['max']:.3e} overflow "
            f"{r['overflow_rms']} | 1M {_ms(r['ms'])} ms (busy "
            f"{_ms(r['busy_ms'])}, host {_ms(r['host_ms'])}) overflow "
            f"{r['overflow']}")
    recs = go("aniso_bounds_probe", lambda: aniso_bounds_probe.main([]),
              ("near_field", "far_gather", "allpairs"))
    for r in recs:
        _held(f"aniso {r['variant']} {r['theta']}", r, "max_abs_err_plain",
              ("near_field", "far_gather", "allpairs"))
        if not math.isfinite(r["rms"]) or (
                r["variant"] == "iso" and r["theta"] <= 0.72
                and not r["rms"] < RMS_BOUND):
            raise AssertionError(f"aniso_bounds_probe: {r}")
        log(f"  aniso {r['variant']} theta {r['theta']}: near tiles "
            f"{r['near_tiles']} ({r['near_tiles_per_target']:.1f} a "
            f"target), far leaf {r['far_leaf_entries']} upper "
            f"{r['far_upper_entries']}, rms {r['rms']:.3e}; masks "
            f"{_ms(r['masks_ms'])} ms, eval {_ms(r['eval_ms'])} ms")
    recs = go("multipole_order_probe",
              lambda: multipole_order_probe.main(it))
    for r in recs[:-1]:
        if "alpha" in r and not all(math.isfinite(r[k]) for k in
                                    ("mono_rms", "quad_rms", "oct_rms")):
            raise AssertionError(f"multipole_order_probe: {r}")
        log("  multipole " + json.dumps({k: v for k, v in r.items()
                                         if k not in ("tool", "card")}))
    t = time.perf_counter()
    reset_launch_counts()
    wide = wide_parent_check(torch.device(DEVICE))
    runs["wide parent"] = {k: v for k, v in launch_counts().items() if v}
    seconds["wide parent"] = time.perf_counter() - t
    log("  wide parent (4 x 40 leaves, staged): " + json.dumps(wide))
    log("phase 20: " + json.dumps({"cuts": STAT_TOOLS_CUTS,
                                   "seconds": seconds, "launches": runs}))
    log(f"stat tools wall time {time.perf_counter() - t0:.1f} s (lines in "
        f"{STAT_TOOLS_LOG})")
    return runs


def phase_budget_heal():
    from benchmark.inputs import plummer
    from parallelnbody_tpu_torch.kernels.launch import COUNTERS
    from parallelnbody_tpu_torch.state import make_state

    with open(CONFIG) as f:
        cfg = SimConfig.from_json(f.read()).replace(n=HEAL_N, bh_leaf_size=0)
    for seed in HEAL_SEEDS:
        pos, vel, mass = plummer.sphere(cfg.n, seed)
        state = make_state(pos, vel, mass, seed=seed, device=DEVICE,
                           dtype=cfg.dtype)
        for k, calls in HEAL_CALLS.items():
            sim = Simulation(cfg, DEVICE, state=state)
            wide = Simulation(cfg.replace(**HEAL_FULL_WIDTH), DEVICE,
                              state=state)
            heals, ms = [], []
            for _ in range(calls):
                before = COUNTERS["bh.heals"]
                _, t = cuda_ms(lambda: sim.step(k))
                heals.append(COUNTERS["bh.heals"] - before)
                ms.append(t)
                if int(sim.overflow):
                    raise AssertionError(f"budget heal: seed {seed} step({k})"
                                         f" call {len(ms)} clipped")
                wide.step(k)
            if int(wide.overflow):
                raise AssertionError(f"budget heal: seed {seed}: the full "
                                     "width run clipped")
            for f in ("pos", "vel", "acc"):
                if not torch.equal(getattr(sim.state, f),
                                   getattr(wide.state, f)):
                    raise AssertionError(f"budget heal: seed {seed} step({k})"
                                         f" {f} differs from full width")
            log(json.dumps({
                "budget_heal": seed, "k": k, "heals_per_call": heals,
                "calibrated": {f: getattr(sim.cfg, f)
                               for f in HEAL_FULL_WIDTH},
                "ms_healed": [round(t, 3) for t, h in zip(ms, heals) if h],
                "ms_median": round(sorted(ms)[len(ms) // 2], 3)}))
            del sim, wide
        del state


# ------------------------------------------ K1's mutual form (phase 22)
def k1_pair_lists(cfg, state, staged):
    """Sorted particles and the whole-set near lists of cfg (calibrated
    budgets) at state, dense or staged, with both forms' work items: the
    one-way items (`near_work(nv)`) and the mutual ones the paths build
    (`near_work(nv, ni, sources=)`)."""
    leaf = cfg.resolve_bh_leaf_size()
    pos_s, mass_s, _, tree, _, n_pad = bh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    n_leaves = n_pad // leaf
    kw = dict(theta=cfg.theta, start_leaf=0, n_slice=n_leaves,
              near_budget=cfg.bh_near_budget, dtype=torch.float32)
    if staged:
        far, rej = bh.traverse(tree, cfg.theta, stop_level=2)
        ni, nv, *_, of = bh.build_interaction_lists_staged(
            tree, far, rej, far_budget=cfg.bh_far_budget,
            cand2_budget=cfg.bh_cand2_budget,
            cand1_budget=cfg.bh_cand_budget, octet_far=True, **kw)
    else:
        far, rej = bh.traverse(tree, cfg.theta)
        ni, nv, *_, of = bh.build_interaction_lists_octet(
            tree, far, rej, far_budget=cfg.bh_far_budget, **kw)
    if int(of) != 0:
        raise AssertionError(f"list overflow {int(of)} at calibrated budgets")
    del far, rej, tree
    return dict(pos_s=pos_s, mass_s=mass_s,
                tgt=pos_s.reshape(n_leaves, leaf, 3), ni=ni, nv=nv,
                one_way=bh_kernels.near_work(nv),
                mutual=bh_kernels.near_work(nv, ni,
                                            sources=(n_leaves, leaf)))


def phase_k1_pairs():
    """K1's mutual form (each mutual leaf pair once) against its one-way
    form on the 1M lists and the 8M staged lists (leaf 128, the benchmark
    cell's, and 256): each form timed in K1_PAIR_ROUNDS rounds of
    alternating KERNEL_REPS launches, against the FP32 bound of the
    ordered pair terms served (both forms serve the same: a served-term
    rate), and the mutual form against the FP32 bound of the work it does
    (its mutual terms at FLOPS_MUTUAL, the one-way terms at 18); the forms
    held to each other in full and to the plain version on sampled rows; the
    mutual share 2 sym / entries; the work items' build time (host wait
    included) and the mutual form's partial slots. Returns one record a
    list set."""
    dev = torch.device(DEVICE)
    out = {}
    for label, path, leaf, staged in K1_PAIR_LISTS:
        with open(path) as f:
            cfg = SimConfig.from_json(f.read())
        if leaf is not None:
            cfg = cfg.replace(bh_leaf_size=leaf)
        if staged:
            cfg = cfg.replace(bh_refine="staged")
        t0 = time.perf_counter()
        state = init_simulation(cfg, dev, compute_forces=False)
        cfg = calibrate_budgets(cfg, state)
        L = k1_pair_lists(cfg, state, staged)
        del state
        torch.cuda.synchronize()
        n_leaves, G, _ = L["tgt"].shape
        one, mut = L["one_way"], L["mutual"]
        kw = dict(g=cfg.g, softening=cfg.softening, compute_pot=False)
        full = near_args(L)
        forms = {"one_way": lambda: bh_kernels.near_field(*full, work=one,
                                                          **kw),
                 "mutual": lambda: bh_kernels.near_field(*full, work=mut,
                                                         **kw)}
        got = {name: fn() for name, fn in forms.items()}
        err = max_err(f"K1 mutual against one-way, {label}", got["mutual"],
                      got["one_way"])
        rows = torch.linspace(0, n_leaves - 1, STAGED_SAMPLE_ROWS,
                              device=dev).long()
        want = bh_kernels.near_field_plain(*near_args(L, rows), **kw)
        rows_g = (rows[:, None] * G + torch.arange(G, device=dev)).reshape(-1)
        err = max(err, max_err(f"K1 mutual against plain, {label}",
                               tuple(t[rows_g] for t in got["mutual"]),
                               want))
        del got, want
        repeat_equal(f"K1 mutual {label}", forms["mutual"])
        times = {name: [] for name in forms}
        for _ in range(K1_PAIR_ROUNDS):
            for name in ("one_way", "mutual", "mutual", "one_way"):
                forms[name]()                                    # warm-up
                times[name].append(cuda_ms(forms[name], KERNEL_REPS)[1])
        work = list_work("near_field", L)
        rec = {"leaves": n_leaves, "leaf": G, "entries": one.entries,
               "sym_entries": mut.sym_entries,
               "paired": 2 * mut.sym_entries / one.entries,
               "n_partial": mut.n_partial,
               "slot_bytes": mut.n_partial * G * 16,
               "items": [one.items.shape[0], mut.items.shape[0],
                         mut.pairs.shape[0]],
               "max_abs_err": err, "bound_ms": work["bound_ms"]}
        for name, ms in times.items():
            rec[f"{name}_ms"] = ms
            rec[f"{name}_share"] = [work["bound_ms"] / m for m in ms]
        rec["mutual_work_bound_ms"] = G * G * (
            (one.entries - 2 * mut.sym_entries) * FLOPS_MONOPOLE +
            mut.sym_entries * FLOPS_MUTUAL) / FP32_FLOPS * 1e3
        rec["mutual_work_share"] = [rec["mutual_work_bound_ms"] / m
                                    for m in rec["mutual_ms"]]
        for name, fn in (("one_way", lambda: bh_kernels.near_work(L["nv"])),
                         ("mutual", lambda: bh_kernels.near_work(
                             L["nv"], L["ni"], sources=(n_leaves, G)))):
            fn()                                                  # warm-up
            rec[f"{name}_work_ms"] = cuda_ms(fn, KERNEL_REPS)[1]
        log(f"K1 forms on the {label} lists ({n_leaves} leaves of {G}, "
            f"near budget {cfg.bh_near_budget}, {one.entries} entries, "
            f"share in mutual pairs {rec['paired']:.4f}; "
            f"{time.perf_counter() - t0:.1f} s): one-way "
            f"{rec['one_way_ms']} ms (share {rec['one_way_share']}), mutual "
            f"{rec['mutual_ms']} ms (served-term rate "
            f"{rec['mutual_share']}; {rec['mutual_work_share']} of its "
            f"work's bound, {rec['mutual_work_bound_ms']:.3f} ms), bound "
            f"{rec['bound_ms']:.3f} ms; items one-way {rec['items'][0]}, "
            f"mutual form {rec['items'][1]} one-way + {rec['items'][2]} "
            f"mutual; {mut.n_partial} slots ({rec['slot_bytes']:.4e} B); "
            f"built in {rec['one_way_work_ms']:.3f} / "
            f"{rec['mutual_work_ms']:.3f} ms; max abs err {err:.3e}")
        out[label] = rec
        del L, one, mut, full, forms
        torch.cuda.empty_cache()
    print(json.dumps({"k1_pairs": out}), flush=True)
    return out


def main():
    t_start = time.perf_counter()
    smi = phase_environment()
    with open(CONFIG) as f:
        cfg_json = f.read()
    with open(ALLPAIRS_CONFIG) as f:
        allpairs_json = f.read()
    with open(STAGED_CONFIG) as f:
        staged_json = f.read()
    with open(GALAXY_CONFIG) as f:
        galaxy_json = f.read()
    with open(XL_CONFIG) as f:
        xl_json = f.read()
    per_pair = phase_build()
    kernels = phase_kernel_parity(cfg_json)
    kernels["allpairs"] = phase_allpairs_parity(allpairs_json)
    kernels["far_gather"] = phase_gather_parity(cfg_json)
    kernels.update(phase_mma())
    for name, value in per_pair.items():
        if name not in EXP_KERNELS:
            kernels[name].update(value)
    # Each kernel's launches are read from the path that carries it.
    launches = phase_octet_path(cfg_json)
    launches["allpairs"] = phase_allpairs_path(allpairs_json)["allpairs"]
    launches["far_gather"] = phase_gather_path(cfg_json)["far_gather"]
    for name in MMA_KERNELS:
        launches[name] = kernels[name].pop("launches")
    phase_crossover()

    phase_staged_parity(staged_json, kernels)
    staged, staged_gather, cfg8 = phase_staged_path(staged_json)
    galaxy, galaxy_times = phase_galaxy_path(galaxy_json)
    cli = phase_cli(galaxy_times, torch.cuda.get_device_name(0))
    xl = phase_sections(cfg8, xl_json)
    for name in ("near_field", "far_octet"):
        kernels[name]["launches_staged8m"] = staged[name]
        kernels[name]["launches_galaxy2m"] = galaxy[name]
        kernels[name]["launches_cli_run_galaxy2m"] = cli["launches"][name]
        kernels[name]["launches_32m"] = xl[name]
    kernels["near_field"]["launches_staged8m_gather"] = \
        staged_gather["near_field"]
    kernels["far_gather"]["launches_staged8m"] = staged_gather["far_gather"]
    phase_ics()
    tools = phase_geometry_tools()
    for name in ("near_field", "far_octet", "far_gather", "allpairs"):
        kernels[name]["launches_geometry_tools"] = {
            label: n[name] for label, n in tools.items() if name in n}
    ports = phase_port_tools()
    for name in ("near_field", "far_octet", "allpairs"):
        kernels[name]["launches_port_tools"] = {
            label: n[name] for label, n in ports.items() if name in n}
    stats = phase_stat_tools()
    with open(LET_CONFIG) as f:
        let_json = f.read()
    kernels.update(phase_k1_forms(let_json))
    dist = phase_distributed(let_json)
    kernels["near_field"]["launches_replicated_tree"] = \
        dist["replicated tree"]["launches"]["near_field"]
    kernels["allpairs"]["launches_mesh_4m"] = dist["mesh"]["launches"]
    kernels["far_gather"]["launches_ring_gather"] = \
        dist["ring gather"]["launches"]["far_gather"]
    launches["near_field_window"] = dist["ring"]["launches"][
        "near_field_window"]
    launches["near_field_table"] = dist["LET example"]["launches"][
        "near_field_table"]
    kernels.update(phase_near_experiments())
    kernels["near_field"]["mutual_form"] = phase_k1_pairs()
    for name in EXP_KERNELS:
        launches[name] = kernels[name].pop("launches")
        kernels[name].update(per_pair.get(name, {}))
    for name in ("near_field", "far_octet", "far_gather", "allpairs",
                 "flat_tune2"):
        kernels[name]["launches_stat_tools"] = {
            label: n[name] for label, n in stats.items() if name in n}
    log("distributed runs (ranks sharing one card): " + json.dumps(
        {k: {m: v[m] for m in ("ms_step", "wall_s") if m in v}
         for k, v in dist.items()}))
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")

    # No single PyTorch call computes any of the eleven functions.
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
    if sys.argv[1:2] == [GEOMETRY_TOOLS_ARG]:
        phase_environment()
        build.load_library()
        with open(sys.argv[2], "w") as f:
            json.dump(geometry_tools(), f)
    elif sys.argv[1:2] == [PORT_TOOLS_ARG]:
        phase_environment()
        build.load_library()
        with open(sys.argv[2], "w") as f:
            json.dump(port_tools(), f)
    elif sys.argv[1:2] == [STAT_TOOLS_ARG]:
        phase_environment()
        build.load_library()
        with open(sys.argv[2], "w") as f:
            json.dump(stat_tools(), f)
    elif sys.argv[1:2] == [BUDGET_HEAL_ARG]:
        phase_environment()
        build.load_library()
        phase_budget_heal()
    elif sys.argv[1:2] == [K1_PAIRS_ARG]:
        phase_environment()
        phase_build()
        phase_k1_pairs()
    else:
        main()
