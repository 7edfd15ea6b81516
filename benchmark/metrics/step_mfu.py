"""The whole step's share of the card's FP32 peak, in per cent: the
all-pairs sum's N^2 * FLOPS_MONOPOLE operations a step at FP32_FLOPS over
the wall seconds a step of the run's untraced window (`step_ms` of the same
run, host clock). It bounds every kernel's share of the step from above,
whatever kernel computes the sum."""

from benchmark.yardstick import FLOPS_MONOPOLE, FP32_FLOPS

NAME = "step_mfu"
UNIT = "%"
BETTER = "higher"
LAYER = "whole step"
MOVES = "step_ms"
SOURCE = "host_clock"


def read(trace):
    flops = float(trace.n) ** 2 * FLOPS_MONOPOLE
    return 100.0 * flops / FP32_FLOPS / trace.step_s
