"""Device idle share of the traced block: 1 - (device busy seconds, the
union of its kernels, copies and fills) / (the block's wall seconds, first
call's start to last call's synchronize). Above 0 the host holds the card
back. The profiler's own cost on the host is inside it."""

NAME = "idle_share"
UNIT = "1"
BETTER = "lower"
LAYER = "device"
MOVES = "step_ms"
SOURCE = "device_trace"


def read(trace):
    return 1.0 - trace.busy_s / trace.window_s
