"""K1's device milliseconds a simulated step: every record of the near-field
kernel and of its combining pass (csrc/near_field.cu: `near_field_kernel`,
`near_combine_kernel`) in the traced block, over its steps. None where the
block ran no K1."""

NAME = "near_ms_per_step"
UNIT = "ms/step"
BETTER = "lower"
LAYER = "K1 near field"
MOVES = "step_ms"
SOURCE = "device_trace"
KERNELS = ("near_field_kernel", "near_combine_kernel")


def read(trace):
    secs = trace.device_s(KERNELS)
    return 1e3 * secs / trace.steps if secs > 0 else None
