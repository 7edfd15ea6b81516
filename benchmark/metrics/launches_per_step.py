"""Runtime calls that put work on the device (kernel launches, copies and
fills: the yardstick's DEVICE_CALLS) a simulated step, from the profiler's
host records of the traced block. A count: it repeats exactly."""

from benchmark.yardstick import DEVICE_CALLS

NAME = "launches_per_step"
UNIT = "1/step"
BETTER = "lower"
LAYER = "host shell"
MOVES = "step_ms"
SOURCE = "device_trace"


def read(trace):
    calls = sum(n for name, n in trace.runtime_calls.items()
                if name in DEVICE_CALLS)
    return calls / trace.steps
