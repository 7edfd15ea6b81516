"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output (`correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, and `checks`:
each compared number beside its limit, also the last lines on standard
error). Exits non-zero, with no result, where torch sees no CUDA device or
fewer than the cell asks for, or where JAX or the JAX package was loaded.

set-up (`setup_s`) counts from the first statement below. Build and kernel
caches stay inside the checkout, under build/ (the program's kernels in
build/kernels/, hash-named).
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "benchmark",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "benchmark",
                                              "triton")
sys.path[0] = ROOT

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
