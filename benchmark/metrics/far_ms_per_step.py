"""K2's device milliseconds a simulated step: every record of the octet
far-field kernel (csrc/far_octet.cu: `far_octet_kernel`) in the traced
block, over its steps. None where the block ran no K2."""

NAME = "far_ms_per_step"
UNIT = "ms/step"
BETTER = "lower"
LAYER = "K2 far field"
MOVES = "step_ms"
SOURCE = "device_trace"
KERNELS = ("far_octet_kernel",)


def read(trace):
    secs = trace.device_s(KERNELS)
    return 1e3 * secs / trace.steps if secs > 0 else None
