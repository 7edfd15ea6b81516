"""Command-line interface. Counterpart of `parallelnbody_tpu/cli.py`:

    run        a simulation, with snapshots, metrics, checkpoints, resume,
               a control file and live frames
    bench      step throughput (per step, or a fused run of --run-steps)
    oracle     energy drift against the native C++ direct-sum oracle
    render     a trajectory directory to PNG/PPM frames
    tree       tree structure and interaction-list statistics
    info       device, version and the resolved config

Every SimConfig field is a flag (`--config FILE` loads a JSON config, flags
override it). The commands run on `--device`, the card ("cuda") unless the
caller names another ("cpu" runs the plain versions of the kernels); a
missing card raises, nothing falls back.

Multi-device runs: `--devices N` or `--devices ICIxDCN` (or a config's
mesh_shape) runs `run` and `bench` on that many ranks, started here
(parallel/mesh.py; on one card they share it, through gloo), rank r on
cuda:(r % cards); `--distributed` makes this process one rank of a group
that a launcher such as torchrun started (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT). Rank 0 writes the snapshots, checkpoints, metrics and the
summary, with the state gathered to it; `--resume` scatters a checkpoint
from rank 0. `tree`, `oracle` and `info` run on one device, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import time

import numpy as np
import torch

from parallelnbody_tpu_torch.config import SimConfig, reference_compat_config
from parallelnbody_tpu_torch.state import SimState, resolve_device


def _add_config_flags(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file (flags override it)")
    for f in dataclasses.fields(SimConfig):
        name = "--" + f.name.replace("_", "-")
        if f.name in ("mesh_shape", "mesh_axes"):
            continue
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None)
        elif isinstance(f.default, int):
            p.add_argument(name, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(name, type=float, default=None)
        else:
            p.add_argument(name, type=str, default=None)
    p.add_argument("--devices", type=str, default="0",
                   help="shard over this many ranks (0 = single device); "
                        "ICIxDCN form (e.g. 8x2) orders the ring slice-major "
                        "so only DCN hops cross slices")
    p.add_argument("--distributed", action="store_true",
                   help="this process is one rank of a group started by a "
                        "launcher (RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT from the environment)")
    p.add_argument("--compat", action="store_true",
                   help="reference-compat profile (G=1e4, slab ICs, "
                        "semi-implicit Euler, theta=1, no softening)")
    _add_device_flag(p)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a card; cpu runs the plain versions)")


def _parse_devices(spec: str) -> tuple:
    if not spec or spec == "0":
        return ()
    if "x" in spec:
        ici, dcn = spec.split("x")
        return (int(ici), int(dcn))
    return (int(spec),)


def _build_config(args) -> SimConfig:
    if args.compat:
        cfg = reference_compat_config(n=args.n or 1024,
                                      size=args.ic_size or 200.0)
    elif args.config:
        with open(args.config) as f:
            cfg = SimConfig.from_json(f.read())
    else:
        cfg = SimConfig()
    return cfg.replace(**_flag_overrides(args))


def _flag_overrides(args, skip=()) -> dict:
    """The SimConfig fields given as flags (mesh_shape from --devices)."""
    out = {f.name: getattr(args, f.name)
           for f in dataclasses.fields(SimConfig)
           if getattr(args, f.name, None) is not None and f.name not in skip}
    shape = _parse_devices(getattr(args, "devices", "0"))
    if shape:
        out["mesh_shape"] = shape
    return out


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


# ------------------------------------------------------------------ ranks
def _on_ranks(args, body) -> int:
    """body(args, cfg, device, group) on one device (group None), as this
    process's rank of a launched group (--distributed), or on cfg's
    mesh_shape of ranks started here. A rank's standard output is rank 0's
    and reaches this process's; returns rank 0's exit code."""
    from parallelnbody_tpu_torch.parallel import mesh

    device = resolve_device(args.device)
    cfg = _build_config(args)
    if getattr(args, "resume", False):
        from parallelnbody_tpu_torch.utils.io import latest_checkpoint

        # The checkpointed config (flags win) decides the rank count.
        ckpt = latest_checkpoint(cfg.checkpoint_dir)
        if ckpt:
            cfg = SimConfig.from_json(ckpt.with_suffix(".json").read_text())
            cfg = cfg.replace(**_flag_overrides(args, skip=("n",)))
    # The auto leaf size resolved once, for the device the run uses, before
    # any rank starts: every rank, plan, evaluation and checkpoint reads it.
    cfg = cfg.with_resolved_leaf(device)
    if args.distributed:
        group = mesh.init_distributed(device)
        if cfg.n_devices not in (1, group.world_size):
            raise SystemExit(f"mesh_shape {cfg.mesh_shape} spans "
                             f"{cfg.n_devices} ranks; the group has "
                             f"{group.world_size}")
        cfg = cfg.replace(mesh_shape=cfg.mesh_shape or (group.world_size,))
        return body(args, cfg, group.device, group)
    if cfg.n_devices > 1:
        outs = mesh.launch(_rank_command, cfg.n_devices, body.__name__,
                           vars(args), cfg.to_json(), device=device,
                           timeout=None)
        sys.stdout.write(outs[0][1])
        return outs[0][0]
    return body(args, cfg, device, None)


def _rank_command(group, body_name, argd, cfg_json):
    """One launched rank of a command: (exit code, rank 0's stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = globals()[body_name](argparse.Namespace(**argd),
                                  SimConfig.from_json(cfg_json), group.device,
                                  group)
    return rc, buf.getvalue() if group.rank == 0 else ""


def _make_sharded_run_k(cfg, group, args):
    """Segment runner on the ranks: the persistent key-sharded run with
    --bh-distributed Barnes-Hut, else a per-step loop. A distributed
    segment that overflows is corrupted (a clipped particle leaves the
    carry, parallel/distributed.py make_distributed_run): it is discarded
    and redone step by step, with a warning. Returns (state, overflow)."""
    from parallelnbody_tpu_torch.parallel import (make_distributed_run,
                                                  make_sharded_step)

    step_fn = make_sharded_step(cfg, group, report_overflow=True)

    def step_k(s, k):
        total = 0
        for _ in range(k):
            s, of = step_fn(s)
            total += int(of)
        return s, total

    if not (cfg.bh_distributed
            and cfg.resolve_force(group.device) == "barnes_hut"):
        return step_k
    runs = {}

    def run_k(s, k):
        if k not in runs:
            runs[k] = make_distributed_run(cfg, group, k)
        out, ovf = runs[k](s)
        ovf = int(ovf)
        if ovf:
            if not args.quiet and group.rank == 0:
                print(f"WARNING: distributed BH clipped {ovf} exchange "
                      f"slots / list entries; discarding the corrupted "
                      f"segment and recomputing it per-step (raise "
                      f"--bh-near-budget/--bh-far-budget or "
                      f"--bh-pair-slack/--bh-own-slack)", file=sys.stderr)
            return step_k(s, k)
        return out, 0

    return run_k


# ------------------------------------------------------------------------ run
# Set-up's spans (api.prepare_simulation) and the keys of their seconds in
# the first record that `run --profile-dir` logs.
SETUP_SPANS = {"api.prepare": "prepare_s", "api.calibrate": "calibrate_s",
               "api.initial_forces": "initial_forces_s"}


def cmd_run(args) -> int:
    return _on_ranks(args, _run_body)


def _run_body(args, cfg, device, group) -> int:
    """`run` on one device (group None) or on this rank of the group."""
    from parallelnbody_tpu_torch.api import (calibrate_budgets,
                                             init_simulation, make_accel_fn,
                                             make_run, prepare_simulation)
    from parallelnbody_tpu_torch.kernels.launch import read_counters
    from parallelnbody_tpu_torch.ops import energy as energy_ops
    from parallelnbody_tpu_torch.utils.io import (
        TrajectoryWriter, latest_checkpoint, load_checkpoint, save_checkpoint)
    from parallelnbody_tpu_torch.utils.metrics import MetricsLogger
    from parallelnbody_tpu_torch.utils.profiling import (force_sync,
                                                         profile_trace,
                                                         take_spans, tracing)

    sharded = group is not None
    lead = not sharded or group.rank == 0
    quiet = args.quiet or not lead
    if sharded:
        from parallelnbody_tpu_torch.parallel import mesh
        from parallelnbody_tpu_torch.parallel.sharded import (
            _accel_fn, sharded_bh_overflow, sharded_diagnostics,
            sharded_init_accel)

    state = None
    setup_s = {}     # set-up's span seconds, under --profile-dir
    if args.resume:
        ckpt = latest_checkpoint(cfg.checkpoint_dir)
        if ckpt:
            # Rank 0 reads the checkpoint and scatters it.
            full = None
            if lead:
                full, ck_cfg = load_checkpoint(ckpt,
                                               "cpu" if sharded else device)
                # Explicit CLI flags still win over the checkpointed config;
                # the ranks keep the mesh they were started on.
                cfg = ck_cfg.replace(**{**_flag_overrides(args, skip=("n",)),
                                        "mesh_shape": cfg.mesh_shape})
            if sharded:
                cfg = SimConfig.from_json(
                    group.broadcast_object(cfg.to_json() if lead else None))
                state = mesh.scatter_state(full, group)
            else:
                state = full
            if lead:
                print(f"resumed from {ckpt} at step {int(state.step)}",
                      file=sys.stderr)

    # Sharded runs are not calibrated (the JAX package's rule): their
    # budgets resolve to the static fallbacks.
    if sharded:
        if state is None:
            state = mesh.shard_state(
                init_simulation(cfg, "cpu", compute_forces=False), group)
        # sharded_init_accel virializes fresh states itself.
        state = sharded_init_accel(cfg, group, state)
    elif state is None:
        # Auto (0) Barnes-Hut budgets are measured on the actual ICs (on a
        # card also one step on) before the run, as Simulation measures
        # them (no-op when all are explicit). Under --profile-dir set-up
        # is traced too: its spans' seconds join the first logged record.
        with tracing(bool(args.profile_dir)):
            cal, state = prepare_simulation(cfg, device)
        for sp in take_spans():
            if sp.name in SETUP_SPANS:
                key = SETUP_SPANS[sp.name]
                setup_s[key] = setup_s.get(key, 0.0) + (
                    sp.end_ns - sp.start_ns) * 1e-9
        if cal != cfg and not quiet:
            print(f"calibrated budgets: near {cal.bh_near_budget} far "
                  f"{cal.bh_far_budget} cand2 {cal.bh_cand2_budget} "
                  f"cand1 {cal.bh_cand_budget}", file=sys.stderr)
        cfg = cal
    else:
        # Resumed state with auto budgets in the (overridden) config:
        # calibrate against the resumed positions.
        cfg = calibrate_budgets(cfg, state)

    def audit_bh_budgets(state):
        """t=0 budget audit through the run's own path (refinement, far
        mode, sections; on ranks the sharded evaluation, which also audits
        the exchange capacities): clipped list entries are lost forces, so
        surface the overflow before a long run (the count is an upper
        bound; zero means nothing was clipped)."""
        if cfg.resolve_force(device) != "barnes_hut":
            return
        if sharded:
            ovf = sharded_bh_overflow(cfg, group, state)
        else:
            from parallelnbody_tpu_torch.ops.bh import make_bh_accel

            cell = [0]
            make_bh_accel(cfg, state.mass, overflow_cell=cell)(state.pos)
            ovf = int(cell[0])
        if ovf and not quiet:
            print(f"WARNING: Barnes-Hut budgets clipped up to {ovf} "
                  f"interaction-list entries; raise --bh-near-budget/"
                  f"--bh-far-budget or theta (forces are degraded for the "
                  f"affected particles)", file=sys.stderr)

    def make_run_k(cfg):
        """run_k(state, k) -> (state, overflow of the k steps, read once)
        through make_run(cfg, k), one program per k, kept; on ranks the
        sharded segment runner."""
        if sharded:
            return _make_sharded_run_k(cfg, group, args)
        runs = {}
        bh = cfg.resolve_force(device) == "barnes_hut"

        def run_k(s, k):
            if k not in runs:
                runs[k] = make_run(cfg, k, report_overflow=bh)
            if bh:
                s, of = runs[k](s)
                return s, int(of)
            return runs[k](s), 0

        return run_k

    audit_bh_budgets(state)
    run_k = make_run_k(cfg)

    traj = (TrajectoryWriter(cfg.snapshot_dir, cfg)
            if cfg.snapshot_every and lead else None)
    metrics = MetricsLogger(args.metrics if lead else None, echo=not quiet)

    pot_fn = None
    if not cfg.track_potential:
        # Hot steps skip the per-step potential (pot stays zeros); recompute
        # it at diagnostics cadence so logged energy/drift are meaningful
        # (as api.Simulation.diagnostics does).
        pot_cfg = cfg.replace(track_potential=True)
        accel_pot = (_accel_fn(pot_cfg, group, state.mass) if sharded
                     else make_accel_fn(pot_cfg, state.mass))
        pot_fn = lambda pos: accel_pot(pos)[1]  # noqa: E731

    def diag(s: SimState) -> dict:
        if pot_fn is not None:
            s = s._replace(pot=pot_fn(s.pos))
        if sharded:
            return sharded_diagnostics(s, group)
        return {k: float(v) for k, v in energy_ops.diagnostics(s).items()}

    def gathered(s):
        """The whole state on rank 0 (None on the others)."""
        return mesh.gather_state(s, group) if sharded else s

    d0 = diag(state)
    e0 = d0["energy"]
    metrics.log({**d0, **setup_s})

    # Cadence: the host loop advances in segments of the gcd of all the
    # "every K steps" knobs, each segment one make_run(cfg, k) call.
    cadences = [c for c in (cfg.log_every, cfg.snapshot_every,
                            cfg.checkpoint_every, args.render_every or 0)
                if c > 0]
    seg = math.gcd(*cadences) if cadences else cfg.steps
    seg = max(1, min(seg, cfg.steps))

    # Runtime control: a JSON control file polled once per segment,
    # {"pause": bool, "dt": float, "stop": bool, "render_extent": float,
    # "render_plane": "xy"|"xz"|"yz", "show_tree": bool}; the view keys
    # steer the --render-every frames live (extent = half-width of the
    # view, i.e. inverse zoom). On ranks, rank 0 reads it and sends the
    # stop flag and dt to the others.
    view = {"extent": None, "plane": args.render_plane,
            "show_tree": bool(args.show_tree)}

    def poll_control():
        nonlocal cfg, runs_invalid
        if not args.control or not os.path.exists(args.control):
            return False
        try:
            with open(args.control) as f:
                ctl = json.loads(f.read())
        except (json.JSONDecodeError, OSError):
            return False
        new_dt = ctl.get("dt")
        if new_dt and new_dt > 0 and new_dt != cfg.dt:
            cfg = cfg.replace(dt=new_dt)
            runs_invalid = True
            if not quiet:
                print(f"control: dt -> {new_dt}", file=sys.stderr)
        new_ext = ctl.get("render_extent")
        if new_ext and new_ext > 0 and new_ext != view["extent"]:
            view["extent"] = float(new_ext)
            if not quiet:
                print(f"control: render_extent -> {new_ext}", file=sys.stderr)
        new_plane = ctl.get("render_plane")
        if new_plane in ("xy", "xz", "yz") and new_plane != view["plane"]:
            view["plane"] = new_plane
            if not new_ext:
                # No explicit extent with the plane switch: recompute the
                # auto extent from the new plane's axes on the next frame.
                view["extent"] = None
            if not quiet:
                print(f"control: render_plane -> {new_plane}", file=sys.stderr)
        if "show_tree" in ctl and bool(ctl["show_tree"]) != view["show_tree"]:
            view["show_tree"] = bool(ctl["show_tree"])
            if not quiet:
                print(f"control: show_tree -> {view['show_tree']}",
                      file=sys.stderr)
        while ctl.get("pause"):
            time.sleep(0.2)
            try:
                with open(args.control) as f:
                    ctl = json.loads(f.read())
            except (json.JSONDecodeError, OSError):
                break
        return bool(ctl.get("stop"))

    def poll_all():
        nonlocal cfg, runs_invalid
        stop = poll_control() if lead else False
        if not sharded:
            return stop
        sent = group.broadcast(torch.tensor(
            [float(stop), cfg.dt], dtype=torch.float64, device=device))
        if float(sent[1]) != cfg.dt:
            cfg = cfg.replace(dt=float(sent[1]))
            runs_invalid = True
        return bool(sent[0])

    # Live frames every --render-every steps as the run progresses, with a
    # view extent fixed from the first frame (control-file overridable) so
    # the sequence animates coherently; --show-tree overlays the occupied
    # leaf boxes. pos and mass reach the host once a frame; the boxes are
    # computed on the run's device.
    def render_frame(s, step_no):
        from parallelnbody_tpu_torch.utils.render import (_AXES, draw_boxes,
                                                          render_ppm,
                                                          tree_boxes,
                                                          write_image)

        pos = s.pos.detach().cpu().numpy()
        m = s.mass.detach().cpu().numpy()
        if view["extent"] is None:
            # Frame the active plane's two axes.
            view["extent"] = float(
                np.percentile(np.abs(pos[:, _AXES[view["plane"]]]),
                              99.0)) * 1.3 or 1.0
        out = f"{args.render_dir}/frame_{step_no:06d}.png"
        img = render_ppm(pos, m, size=args.render_size,
                         extent=view["extent"], plane=view["plane"])
        if view["show_tree"]:
            lo, hi = tree_boxes(s.pos, s.mass,
                                leaf_size=cfg.resolve_bh_leaf_size(),
                                curve=cfg.bh_curve)
            draw_boxes(img, lo, hi, extent=view["extent"],
                       plane=view["plane"])
        write_image(out, img)

    def write_outputs(s, step_no, done):
        """The frame, snapshot and checkpoint due after `done` steps, from
        the state gathered to rank 0 (every rank decides alike)."""
        frame = bool(args.render_every) and done % args.render_every == 0
        snap = bool(cfg.snapshot_every) and done % cfg.snapshot_every == 0
        ckpt = bool(cfg.checkpoint_every) and \
            done % cfg.checkpoint_every == 0
        if frame or snap or ckpt:
            full = gathered(s)
            if lead:
                if frame:
                    render_frame(full, step_no)
                if snap:
                    traj.append(full)
                if ckpt:
                    save_checkpoint(cfg.checkpoint_dir, full, cfg)

    def checkpoint_now(s):
        full = gathered(s)
        if lead:
            save_checkpoint(cfg.checkpoint_dir, full, cfg)

    if args.render_every:
        # Label by the absolute step so a --resume continues the frame
        # sequence instead of overwriting frame_000000.png.
        full = gathered(state)
        if lead:
            render_frame(full, int(state.step))

    runs_invalid = False
    interrupted = False
    ovf_total = 0
    t_start = time.perf_counter()
    done = 0
    last_t = t_start
    # --profile-dir: the program's spans join the profiler's trace, and on
    # one device each logged record gains the segment's interactions a
    # second (K3 pairs, or K1 pair terms and far terms), host reads a step
    # and list rebuilds after a calibrated budget clipped (`bh_heals`),
    # from the kernel wrappers' counters.
    prof_dir = args.profile_dir if lead else None
    counting = bool(prof_dir) and not sharded
    with profile_trace(prof_dir), \
            (tracing(True) if prof_dir else contextlib.nullcontext()):
        try:
            while done < cfg.steps:
                if poll_all():
                    checkpoint_now(state)
                    if not quiet:
                        print("control: stop (checkpoint saved)", file=sys.stderr)
                    break
                if runs_invalid:
                    # dt changed: new step programs.
                    runs_invalid = False
                    run_k = make_run_k(cfg)
                k = min(seg, cfg.steps - done)
                before = read_counters() if counting else None
                state, seg_ovf = run_k(state, k)
                after = read_counters() if counting else None
                take_spans()   # the profiler keeps them; drop the records
                done += k
                if seg_ovf:
                    # Mid-run clipping: the t=0 audit cannot catch a state
                    # that only starts overflowing as the system evolves.
                    if not ovf_total and not quiet:
                        print(f"WARNING: Barnes-Hut budgets started clipping "
                              f"mid-run at step ~{done} ({seg_ovf} entries "
                              f"this segment); raise --bh-near-budget/"
                              f"--bh-far-budget (forces are degraded for the "
                              f"affected particles)", file=sys.stderr)
                    ovf_total += seg_ovf
                step_now = int(force_sync(state.step))
                now = time.perf_counter()
                if cfg.log_every and done % cfg.log_every == 0:
                    record = diag(state)
                    record["energy_drift"] = (record["energy"] - e0) / abs(e0 or 1.0)
                    record["steps_per_sec"] = k / (now - last_t)
                    if counting:
                        work = sum(after[c] - before[c] for c in
                                   ("k3.pairs", "k1.pair_terms", "far.terms"))
                        record["interactions_per_sec"] = work / (now - last_t)
                        record["host_reads_per_step"] = (
                            after["host_reads"] - before["host_reads"]) / k
                        record["bh_heals"] = (after["bh.heals"]
                                              - before["bh.heals"])
                        # K1's pair terms served, and those evaluated once
                        # for both leaves (the mutual form, on the card).
                        for c in ("k1.pair_terms", "k1.sym_terms"):
                            record[c.replace(".", "_")] = (after[c]
                                                           - before[c])
                    if ovf_total:
                        record["bh_overflow"] = ovf_total
                    metrics.log(record)
                last_t = now
                write_outputs(state, step_now, done)
        except KeyboardInterrupt:
            # Clean interrupt: checkpoint the last completed segment so a
            # --resume continues exactly here.
            interrupted = True
            checkpoint_now(state)
            if not quiet:
                print(f"interrupted at step {int(state.step)}; checkpoint "
                      f"saved to {cfg.checkpoint_dir}", file=sys.stderr)

    total = time.perf_counter() - t_start
    d1 = diag(state)
    summary = {
        "steps": done,
        "n": cfg.n,
        "force": cfg.resolve_force(device),
        "interrupted": interrupted,
        "wall_s": total,
        "steps_per_sec": done / total if total > 0 else 0.0,
        "energy_drift": (d1["energy"] - e0) / abs(e0 or 1.0),
        "momentum_norm": d1["momentum_norm"],
        "bh_overflow": ovf_total,
    }
    if lead:
        print(json.dumps(summary))
    metrics.close()
    return 0


# ---------------------------------------------------------------------- bench
def cmd_bench(args) -> int:
    return _on_ranks(args, _bench_body)


def _bench_body(args, cfg, device, group) -> int:
    """Step throughput of the single-device step (make_step), or with
    --run-steps K of a fused make_run(cfg, K), the production path (with
    bh_rebuild_every > 1 the tree-rebuild-interval program). The budgets
    are calibrated first, so the program timed is the one `run` executes.
    On ranks (group given): the sharded step, or with --run-steps the
    persistent distributed run (--bh-distributed) or the sharded run, as
    the JAX package times them (budgets not calibrated); the time is rank
    0's, with every rank's work finished. On a CUDA device the loop is
    timed by CUDA events on one device, elsewhere by the host clock; the
    overflow stays on the device until the loop ends."""
    from parallelnbody_tpu_torch.api import (init_simulation, make_run,
                                             make_step, prepare_simulation)

    run_steps = args.run_steps
    per_call = run_steps or 1
    method = cfg.resolve_force(device)
    bh = method == "barnes_hut"
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    if group is None:
        cfg, state = prepare_simulation(cfg, device)
        step = (make_run(cfg, run_steps, report_overflow=True) if run_steps
                else make_step(cfg, report_overflow=True))
    else:
        from parallelnbody_tpu_torch.parallel import mesh, sharded as sh
        from parallelnbody_tpu_torch.parallel.distributed import \
            make_distributed_run

        state = sh.sharded_init_accel(cfg, group, mesh.shard_state(
            init_simulation(cfg, "cpu", compute_forces=False), group))
        if run_steps and cfg.bh_distributed and bh:
            step = make_distributed_run(cfg, group, run_steps)
        elif run_steps:
            sharded_run = sh.make_sharded_run(cfg, group, run_steps)

            def step(s):
                return sharded_run(s), torch.zeros_like(overflow)
        else:
            step = sh.make_sharded_step(cfg, group, report_overflow=True)

    def call(s):
        nonlocal overflow
        s, of = step(s)
        overflow = overflow + of
        return s

    def finish():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if group is not None:
            group.all_reduce(torch.zeros(1, device=device))

    state = call(state)                    # warm-up
    iters = args.iters
    if device.type == "cuda" and group is None:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state = call(state)
        end.record()
        torch.cuda.synchronize(device)
        dt = start.elapsed_time(end) / 1e3 / (iters * per_call)
    else:
        finish()
        t0 = time.perf_counter()
        for _ in range(iters):
            state = call(state)
        finish()
        dt = (time.perf_counter() - t0) / (iters * per_call)
    n_dev = 1 if group is None else group.world_size
    out = {
        "n": cfg.n,
        "force": method,
        "devices": n_dev,
        "device": _device_name(device),
        "ms_per_step": dt * 1e3,
        "steps_per_sec": 1.0 / dt,
    }
    if run_steps:
        out["run_steps"] = run_steps
        out["bh_rebuild_every"] = cfg.bh_rebuild_every
        if bh:
            out["overflow"] = int(overflow)
    if method in ("direct", "direct_pallas"):
        out["interactions_per_sec"] = cfg.n * cfg.n / dt
        out["interactions_per_sec_per_chip"] = cfg.n * cfg.n / dt / n_dev
    if group is None or group.rank == 0:
        print(json.dumps(out))
    return 0


# --------------------------------------------------------------------- oracle
def cmd_oracle(args) -> int:
    """Energy-drift parity vs the native C++ double-precision oracle."""
    from parallelnbody_tpu_torch.api import make_run, prepare_simulation
    from parallelnbody_tpu_torch.native import Oracle

    device = resolve_device(args.device)
    cfg = _build_config(args)
    cfg, state = prepare_simulation(cfg, device)
    pos0 = state.pos.cpu().numpy()
    vel0 = state.vel.cpu().numpy()
    mass = state.mass.cpu().numpy()

    oracle = Oracle(g=cfg.g, softening=cfg.softening)
    e0 = oracle.total_energy(pos0, vel0, mass)
    out, overflow = make_run(cfg, cfg.steps, report_overflow=True)(state)
    pos1 = out.pos.cpu().numpy()
    vel1 = out.vel.cpu().numpy()
    e1 = oracle.total_energy(pos1, vel1, mass)
    drift = abs((e1 - e0) / e0) if e0 else float("nan")

    report = {"n": cfg.n, "steps": cfg.steps,
              "force": cfg.resolve_force(device),
              "integrator": cfg.integrator, "energy_initial": e0,
              "energy_final": e1, "relative_drift": drift,
              "target": 1e-4, "pass": bool(drift < 1e-4),
              "bh_overflow": int(overflow), "device": _device_name(device)}
    if args.trajectory and cfg.n <= 8192:
        pos_c, _ = oracle.run(pos0, vel0, mass, cfg.dt, cfg.steps,
                              integrator=cfg.integrator
                              if cfg.integrator in ("leapfrog", "euler_semi_implicit")
                              else "leapfrog")
        scale = float(np.max(np.linalg.norm(pos_c, axis=1)))
        report["trajectory_rel_err"] = float(
            np.max(np.linalg.norm(pos_c - pos1, axis=1)) / scale)
    print(json.dumps(report))
    return 0 if report["pass"] else 1


# --------------------------------------------------------------------- render
def cmd_render(args) -> int:
    from parallelnbody_tpu_torch.utils.render import render_trajectory

    written = render_trajectory(args.traj_dir, args.out, size=args.size,
                                plane=args.plane, fmt=args.fmt,
                                show_tree=args.show_tree, device=args.device)
    print(json.dumps({"frames_rendered": len(written),
                      "show_tree": bool(args.show_tree),
                      "out_dir": str(written[0].parent) if written else None}))
    return 0


# ----------------------------------------------------------------------- tree
def cmd_tree(args) -> int:
    """Tree structure dump: depth, level widths, leaf-radius and list-length
    percentiles, overflow, at the config's budgets (0 = the static
    fallbacks, as in the JAX package); "requirements" holds the exact
    per-target list maxima that api.calibrate_budgets derives the auto
    budgets from."""
    from parallelnbody_tpu_torch.api import init_simulation
    from parallelnbody_tpu_torch.ops.bh import (measure_budget_requirements,
                                                tree_stats)

    device = resolve_device(args.device)
    cfg = _build_config(args).with_resolved_leaf(device)
    state = init_simulation(cfg, device, compute_forces=False)
    out = tree_stats(state.pos, state.mass, cfg)
    if cfg.resolve_force(device) == "barnes_hut":
        out["requirements"] = measure_budget_requirements(state.pos,
                                                          state.mass, cfg)
    print(json.dumps(out, indent=2))
    return 0


# ----------------------------------------------------------------------- info
def cmd_info(args) -> int:
    from parallelnbody_tpu_torch import __version__

    device = resolve_device(args.device)
    cfg = _build_config(args)
    if device.type == "cuda":
        devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [str(device)]
    print(json.dumps({
        "backend": device.type,
        "device": str(device),
        "device_name": _device_name(device),
        "devices": devices,
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "resolved_force": cfg.resolve_force(device),
        # The config as given; its auto leaf size as a run on this device
        # resolves it.
        "resolved_bh_leaf_size": cfg.resolve_bh_leaf_size(device),
        "config": json.loads(cfg.to_json()),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="parallelnbody_tpu_torch",
        description="N-body simulation framework, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a simulation")
    _add_config_flags(pr)
    pr.add_argument("--metrics", type=str, default=None, help="metrics JSONL path")
    pr.add_argument("--profile-dir", type=str, default=None,
                    help="torch.profiler Chrome trace dir; also traces the "
                         "program's phases and logs set-up's split, "
                         "interactions/s and host reads/step")
    pr.add_argument("--resume", action="store_true",
                    help="resume from latest checkpoint")
    pr.add_argument("--control", type=str, default=None,
                    help="JSON control file polled each segment: "
                         '{"pause": bool, "dt": float, "stop": bool, '
                         '"render_extent": float, "render_plane": '
                         '"xy"|"xz"|"yz", "show_tree": bool}')
    pr.add_argument("--render-every", type=int, default=0,
                    help="emit a PNG frame every K steps during the run "
                         "(0 = off)")
    pr.add_argument("--render-dir", type=str, default="frames",
                    help="output directory for --render-every frames")
    pr.add_argument("--render-size", type=int, default=512,
                    help="frame size in pixels for --render-every")
    pr.add_argument("--render-plane", choices=("xy", "xz", "yz"),
                    default="xy", help="projection plane for live frames "
                    "(control-file render_plane overrides mid-run)")
    pr.add_argument("--show-tree", action="store_true",
                    help="overlay occupied tree-leaf boxes on live frames")
    pr.add_argument("--quiet", action="store_true")
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("bench", help="measure step throughput")
    _add_config_flags(pb)
    pb.add_argument("--iters", type=int, default=10)
    pb.add_argument("--run-steps", type=int, default=0,
                    help="time a fused make_run of this many steps instead "
                         "of per-step make_step (0 = per-step); with "
                         "--bh-rebuild-every k the tree-rebuild-interval "
                         "program")
    pb.set_defaults(fn=cmd_bench)

    po = sub.add_parser("oracle", help="energy-drift parity vs C++ oracle")
    _add_config_flags(po)
    po.add_argument("--trajectory", action="store_true",
                    help="also compare full trajectories (small N)")
    po.set_defaults(fn=cmd_oracle)

    pi = sub.add_parser("info", help="device / version / config info")
    _add_config_flags(pi)
    pi.set_defaults(fn=cmd_info)

    pv = sub.add_parser("render", help="render a trajectory dir to PPM frames")
    pv.add_argument("traj_dir")
    pv.add_argument("--out", type=str, default=None)
    pv.add_argument("--size", type=int, default=512)
    pv.add_argument("--plane", choices=("xy", "xz", "yz"), default="xy")
    pv.add_argument("--fmt", choices=("png", "ppm"), default="png")
    pv.add_argument("--show-tree", action="store_true",
                    help="overlay occupied tree-leaf boxes, computed on "
                         "--device")
    _add_device_flag(pv)
    pv.set_defaults(fn=cmd_render)

    pt = sub.add_parser("tree", help="dump tree structure + list statistics")
    _add_config_flags(pt)
    pt.set_defaults(fn=cmd_tree)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
