"""The readings that a cell's limits are set from, at the cell's own size,
in one process (set-up is long, so one process reads every seed):

    python3 benchmark/control.py --workload <cell> --seeds S1 S2 ...
        [--control-seeds C1 C2 C3] [--seconds 2] [--out FILE]

For each seed, one run of the cell (a short window at the cell's own load)
gives the program's numbers (check.py): the largest over the seeds is the
lower reading. On the control seeds the reference is also put in the
program's place on the same judged calls, computed in bfloat16 (the
control) and in float32 (check.CONTROLS): the smallest over those seeds is
each precision's upper reading. One JSON line a seed and
a summary line; each also appended to --out. The benchmark's own runs never
run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "benchmark",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "benchmark",
                                              "triton")
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import check, manifest  # noqa: E402
from benchmark.harness import run_cell  # noqa: E402

PRECISIONS = ("bfloat16", "float32")
COMPARED = ("acc_err", "dx_err", "dv_err")


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def readings(workload, seeds, control_seeds, seconds, device="cuda",
             overrides=None, out=None):
    """{"lower": {number: largest over the program's seeds}, "upper":
    {precision: {number: smallest over the control seeds}}, "correct":
    the seeds whose run read correct}."""
    cell = manifest.load_cell(workload)
    lower = dict.fromkeys(COMPARED, 0.0)
    upper = {p: dict.fromkeys(COMPARED, float("inf")) for p in PRECISIONS}
    correct = []
    for seed in seeds:
        controls = PRECISIONS if seed in control_seeds else ()
        res = run_cell(cell, seed, seconds, device=device,
                       overrides=overrides, controls=controls)
        got = {name: res["checks"][name]["value"] for name in check.NUMBERS}
        for name in COMPARED:
            lower[name] = max(lower[name], got[name])
        for p, numbers in res.get("control", {}).items():
            for name in COMPARED:
                upper[p][name] = min(upper[p][name], numbers[name])
        if res["correct"]:
            correct.append(seed)
        emit({"workload": workload, "seed": seed, "correct": res["correct"],
              "numbers": got, "control": res.get("control"),
              "attempted": res["attempted"], "metrics": res["metrics"],
              "device": res["device"]}, out)
    summary = {"workload": workload, "seeds": list(seeds),
               "control_seeds": list(control_seeds), "lower": lower,
               "upper": upper, "correct": correct}
    emit(summary, out)
    return summary


def main(argv):
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    readings(args.workload, seeds, set(args.control_seeds), args.seconds,
             out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
