"""Share (%) of the profiled stretch of generating calls in which no device
operation ran: 1 - (union of kernel, copy and set intervals) / the
stretch's length. The profiler's own host work is inside the stretch."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.device_idle(outcome)
