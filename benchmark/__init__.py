"""The benchmark of parallelnbody_tpu_torch on one or more CUDA cards.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Everything that defines a measurement lives here and nowhere in the
program: the inputs (`inputs/`), the float64 reference (`reference/`), the
comparison that decides `correct` (`check.py`), the peaks and the
whole-reading rule of a profiler trace (`yardstick.py`), one file per
configuration (`configs/`), traffic mix (`traffic/`), cell (`workloads/`)
and per-layer metric (`metrics/`). Nothing here imports JAX or the JAX
package.
"""
