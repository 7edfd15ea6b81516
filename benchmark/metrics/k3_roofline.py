"""K3's share of its roofline, in per cent: the least time of a step's
all-pairs sum over K3's device time a step (ops/direct_kernels.py
allpairs, csrc/allpairs.cu: its kernel and its combine kernel). The work is
N^2 softened monopole pairs whatever computes them: FLOPS_MONOPOLE FP32
operations and one rsqrt each; the bytes are the positions and masses read
once (16 N) and the accelerations written once (12 N). The least time is
the largest of the FP32, MUFU and HBM times at the published peaks. None
where the traced block ran no K3."""

from benchmark.yardstick import FLOPS_MONOPOLE, least_seconds

NAME = "k3_roofline"
UNIT = "%"
BETTER = "higher"
LAYER = "K3 all-pairs"
MOVES = "step_ms"
SOURCE = "device_trace"
KERNELS = ("allpairs_kernel", "allpairs_combine_kernel")


def read(trace):
    secs = trace.device_s(KERNELS) / trace.steps
    if secs <= 0:
        return None
    least, _ = least_seconds(float(trace.n) ** 2, FLOPS_MONOPOLE,
                             28 * trace.n)
    return 100.0 * least / secs
