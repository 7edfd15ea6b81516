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
missing card raises, nothing falls back. Only single-device runs are
ported: `--devices` other than 0, `--distributed` and a config whose
mesh_shape spans several devices fail with a message, since the
multi-device paths (the JAX package's parallel/) are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from parallelnbody_tpu_torch.config import SimConfig, reference_compat_config
from parallelnbody_tpu_torch.state import SimState, resolve_device

_NOT_PORTED = ("multi-device runs are not ported to parallelnbody_tpu_torch "
               "yet (the JAX package's parallel/); run on one device "
               "(--devices 0, no --distributed, an empty mesh_shape) or use "
               "`python -m parallelnbody_tpu`")


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
                   help="0 = single device (the only setting ported; others "
                        "fail, the multi-device paths are not ported yet)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host (not ported yet: fails)")
    p.add_argument("--compat", action="store_true",
                   help="reference-compat profile (G=1e4, slab ICs, "
                        "semi-implicit Euler, theta=1, no softening)")
    _add_device_flag(p)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a card; cpu runs the plain versions)")


def _require_single_device(cfg: SimConfig):
    if cfg.n_devices > 1:
        raise SystemExit(f"parallelnbody_tpu_torch: mesh_shape "
                         f"{cfg.mesh_shape}: {_NOT_PORTED}")


def _build_config(args) -> SimConfig:
    if getattr(args, "distributed", False):
        raise SystemExit(f"parallelnbody_tpu_torch: --distributed: "
                         f"{_NOT_PORTED}")
    if args.devices not in ("", "0"):
        raise SystemExit(f"parallelnbody_tpu_torch: --devices "
                         f"{args.devices}: {_NOT_PORTED}")
    if args.compat:
        cfg = reference_compat_config(n=args.n or 1024,
                                      size=args.ic_size or 200.0)
    elif args.config:
        with open(args.config) as f:
            cfg = SimConfig.from_json(f.read())
    else:
        cfg = SimConfig()
    cfg = cfg.replace(**_flag_overrides(args))
    _require_single_device(cfg)
    return cfg


def _flag_overrides(args, skip=()) -> dict:
    """The SimConfig fields given as flags."""
    return {f.name: getattr(args, f.name)
            for f in dataclasses.fields(SimConfig)
            if getattr(args, f.name, None) is not None and f.name not in skip}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


# ------------------------------------------------------------------------ run
_AUTO_BUDGET_FIELDS = ("bh_near_budget", "bh_far_budget",
                       "bh_cand2_budget", "bh_cand_budget")


def recalibrate_on_overflow(cfg, state, auto_fields):
    """Self-healing budgets: when a segment reports overflow on a config
    whose budgets were auto-calibrated at t=0, re-measure the evolved
    geometry (a collapsing merger packs more near leaves per target than
    its t=0 state) and grow any budget that the fresh measurement says is
    too small. Only the originally-auto fields move (explicit budgets are
    the user's word), and only upward. Returns (cfg, grew), grew mapping
    the raised fields to their new values ({} = nothing to do).

    The clipped segment itself is not recomputed: a clip costs one segment
    of degraded force for the affected particles (bounded, warned); the
    heal is for the rest of the run."""
    from parallelnbody_tpu_torch.api import calibrate_budgets

    fresh = calibrate_budgets(cfg.replace(**{f: 0 for f in auto_fields}),
                              state)
    grew = {f: getattr(fresh, f) for f in auto_fields
            if getattr(fresh, f) > getattr(cfg, f)}
    return (cfg.replace(**grew) if grew else cfg), grew


def cmd_run(args) -> int:
    from parallelnbody_tpu_torch.api import (_fill_initial_forces,
                                             calibrate_budgets,
                                             init_simulation, make_accel_fn,
                                             make_run)
    from parallelnbody_tpu_torch.ops import energy as energy_ops
    from parallelnbody_tpu_torch.utils.io import (
        TrajectoryWriter, latest_checkpoint, load_checkpoint, save_checkpoint)
    from parallelnbody_tpu_torch.utils.metrics import MetricsLogger
    from parallelnbody_tpu_torch.utils.profiling import (force_sync,
                                                         profile_trace)

    device = resolve_device(args.device)
    cfg = _build_config(args)

    state = None
    if args.resume:
        ckpt = latest_checkpoint(cfg.checkpoint_dir)
        if ckpt:
            state, cfg = load_checkpoint(ckpt, device)
            # Explicit CLI flags still win over the checkpointed config.
            cfg = cfg.replace(**_flag_overrides(args, skip=("n",)))
            _require_single_device(cfg)
            print(f"resumed from {ckpt} at step {int(state.step)}",
                  file=sys.stderr)

    # Which budget fields arrived as 0 = auto (before calibration fills
    # them): these are the fields recalibrate_on_overflow may grow mid-run.
    # A resumed checkpoint carries calibrated budgets, so resumed runs heal
    # only via explicit flags.
    auto_budget_fields = ([f for f in _AUTO_BUDGET_FIELDS
                           if getattr(cfg, f) == 0]
                          if cfg.resolve_force(device) == "barnes_hut"
                          else [])
    if state is None:
        # Auto (0) Barnes-Hut budgets are measured on the actual ICs before
        # the first force evaluation (no-op when all are explicit).
        state = init_simulation(cfg, device, compute_forces=False)
        cal = calibrate_budgets(cfg, state)
        if cal is not cfg and not args.quiet:
            print(f"calibrated budgets: near {cal.bh_near_budget} far "
                  f"{cal.bh_far_budget} cand2 {cal.bh_cand2_budget} "
                  f"cand1 {cal.bh_cand_budget}", file=sys.stderr)
        cfg = cal
        state = _fill_initial_forces(cfg, state)
    else:
        # Resumed state with auto budgets in the (overridden) config:
        # calibrate against the resumed positions.
        cfg = calibrate_budgets(cfg, state)

    def audit_bh_budgets(state):
        """t=0 budget audit through the run's own path (refinement, far
        mode, sections): clipped list entries are lost forces, so surface
        the overflow before a long run (the count is an upper bound; zero
        means nothing was clipped)."""
        if cfg.resolve_force(device) != "barnes_hut":
            return
        from parallelnbody_tpu_torch.ops.bh import bh_accel

        _, _, ovf = bh_accel(
            state.pos, state.mass, leaf_size=cfg.resolve_bh_leaf_size(),
            theta=cfg.theta, g=cfg.g, softening=cfg.softening,
            near_budget=cfg.resolve_bh_near_budget(),
            far0_budget=cfg.resolve_bh_far_budget(), curve=cfg.bh_curve,
            multipole=cfg.bh_multipole, max_levels=cfg.bh_max_levels,
            refine=cfg.resolve_bh_refine(),
            cand_budgets=(cfg.bh_cand2_budget, cfg.bh_cand_budget),
            far_mode=cfg.bh_far_mode, sections=cfg.bh_sections)
        ovf = int(ovf)
        if ovf and not args.quiet:
            print(f"WARNING: Barnes-Hut budgets clipped up to {ovf} "
                  f"interaction-list entries; raise --bh-near-budget/"
                  f"--bh-far-budget or theta (forces are degraded for the "
                  f"affected particles)", file=sys.stderr)

    def make_run_k(cfg):
        """run_k(state, k) -> (state, overflow of the k steps, read once)
        through make_run(cfg, k), one program per k, kept."""
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

    traj = TrajectoryWriter(cfg.snapshot_dir, cfg) if cfg.snapshot_every else None
    metrics = MetricsLogger(args.metrics, echo=not args.quiet)

    pot_fn = None
    if not cfg.track_potential:
        # Hot steps skip the per-step potential (pot stays zeros); recompute
        # it at diagnostics cadence so logged energy/drift are meaningful
        # (as api.Simulation.diagnostics does).
        accel_pot = make_accel_fn(cfg.replace(track_potential=True),
                                  state.mass)
        pot_fn = lambda pos: accel_pot(pos)[1]  # noqa: E731

    def diag(s: SimState) -> dict:
        if pot_fn is not None:
            s = s._replace(pot=pot_fn(s.pos))
        return {k: float(v) for k, v in energy_ops.diagnostics(s).items()}

    d0 = diag(state)
    e0 = d0["energy"]
    metrics.log(d0)

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
    # view, i.e. inverse zoom).
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
            if not args.quiet:
                print(f"control: dt -> {new_dt}", file=sys.stderr)
        new_ext = ctl.get("render_extent")
        if new_ext and new_ext > 0 and new_ext != view["extent"]:
            view["extent"] = float(new_ext)
            if not args.quiet:
                print(f"control: render_extent -> {new_ext}", file=sys.stderr)
        new_plane = ctl.get("render_plane")
        if new_plane in ("xy", "xz", "yz") and new_plane != view["plane"]:
            view["plane"] = new_plane
            if not new_ext:
                # No explicit extent with the plane switch: recompute the
                # auto extent from the new plane's axes on the next frame.
                view["extent"] = None
            if not args.quiet:
                print(f"control: render_plane -> {new_plane}", file=sys.stderr)
        if "show_tree" in ctl and bool(ctl["show_tree"]) != view["show_tree"]:
            view["show_tree"] = bool(ctl["show_tree"])
            if not args.quiet:
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

    if args.render_every:
        # Label by the absolute step so a --resume continues the frame
        # sequence instead of overwriting frame_000000.png.
        render_frame(state, int(state.step))

    runs_invalid = False
    interrupted = False
    ovf_total = 0
    t_start = time.perf_counter()
    done = 0
    last_t = t_start
    with profile_trace(args.profile_dir):
        try:
            while done < cfg.steps:
                if poll_control():
                    save_checkpoint(cfg.checkpoint_dir, state, cfg)
                    if not args.quiet:
                        print("control: stop (checkpoint saved)", file=sys.stderr)
                    break
                if runs_invalid:
                    # dt or budgets changed: new step programs.
                    runs_invalid = False
                    run_k = make_run_k(cfg)
                k = min(seg, cfg.steps - done)
                state, seg_ovf = run_k(state, k)
                done += k
                if seg_ovf:
                    # Mid-run clipping: the t=0 audit cannot catch a state
                    # that only starts overflowing as the system evolves.
                    if not ovf_total and not args.quiet:
                        print(f"WARNING: Barnes-Hut budgets started clipping "
                              f"mid-run at step ~{done} ({seg_ovf} entries "
                              f"this segment); raise --bh-near-budget/"
                              f"--bh-far-budget (forces are degraded for the "
                              f"affected particles)", file=sys.stderr)
                    ovf_total += seg_ovf
                    if auto_budget_fields:
                        # Self-heal auto budgets from the evolved geometry:
                        # grow only what clipped, rebuild the programs.
                        cfg, grew = recalibrate_on_overflow(
                            cfg, state, auto_budget_fields)
                        if grew:
                            runs_invalid = True
                            if not args.quiet:
                                print(f"recalibrated budgets after overflow: "
                                      f"{grew}", file=sys.stderr)
                step_now = int(force_sync(state.step))
                now = time.perf_counter()
                if cfg.log_every and done % cfg.log_every == 0:
                    record = diag(state)
                    record["energy_drift"] = (record["energy"] - e0) / abs(e0 or 1.0)
                    record["steps_per_sec"] = k / (now - last_t)
                    if ovf_total:
                        record["bh_overflow"] = ovf_total
                    metrics.log(record)
                last_t = now
                if args.render_every and done % args.render_every == 0:
                    render_frame(state, step_now)
                if traj and done % cfg.snapshot_every == 0:
                    traj.append(state)
                if cfg.checkpoint_every and done % cfg.checkpoint_every == 0:
                    save_checkpoint(cfg.checkpoint_dir, state, cfg)
        except KeyboardInterrupt:
            # Clean interrupt: checkpoint the last completed segment so a
            # --resume continues exactly here.
            interrupted = True
            save_checkpoint(cfg.checkpoint_dir, state, cfg)
            if not args.quiet:
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
    print(json.dumps(summary))
    metrics.close()
    return 0


# ---------------------------------------------------------------------- bench
def cmd_bench(args) -> int:
    """Step throughput of the single-device step (make_step), or with
    --run-steps K of a fused make_run(cfg, K), the production path (with
    bh_rebuild_every > 1 the tree-rebuild-interval program). The budgets
    are calibrated first, so the program timed is the one `run` executes.
    On a CUDA device the loop is timed by CUDA events, elsewhere by the
    host clock; the overflow stays on the device until the loop ends."""
    from parallelnbody_tpu_torch.api import (make_run, make_step,
                                             prepare_simulation)

    device = resolve_device(args.device)
    cfg = _build_config(args)
    cfg, state = prepare_simulation(cfg, device)
    method = cfg.resolve_force(device)
    bh = method == "barnes_hut"
    run_steps = args.run_steps
    step = (make_run(cfg, run_steps, report_overflow=True) if run_steps
            else make_step(cfg, report_overflow=True))
    per_call = run_steps or 1
    overflow = torch.zeros((), dtype=torch.int32, device=device)

    def call(s):
        nonlocal overflow
        s, of = step(s)
        overflow = overflow + of
        return s

    state = call(state)                    # warm-up
    iters = args.iters
    if device.type == "cuda":
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
        t0 = time.perf_counter()
        for _ in range(iters):
            state = call(state)
        dt = (time.perf_counter() - t0) / (iters * per_call)
    out = {
        "n": cfg.n,
        "force": method,
        "devices": 1,
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
        out["interactions_per_sec_per_chip"] = cfg.n * cfg.n / dt
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
    cfg = _build_config(args)
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
                    help="torch.profiler Chrome trace dir")
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
