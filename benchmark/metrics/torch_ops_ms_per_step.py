"""Device milliseconds a step of every record that is not one of the
program's hand-written kernels (the `__global__` functions of its csrc/,
read at run time, so a kernel added later leaves this sum by itself): the
geometry, the integrator and the glue as PyTorch ops, copies and fills."""

NAME = "torch_ops_ms_per_step"
UNIT = "ms/step"
BETTER = "lower"
LAYER = "geometry and integrator"
MOVES = "step_ms"
SOURCE = "device_trace"


def read(trace):
    return 1e3 * trace.device_s(exclude=trace.hand_kernels) / trace.steps
