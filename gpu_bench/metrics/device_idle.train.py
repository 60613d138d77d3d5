"""Share (%) of the profiled stretch of training steps in which no device
operation ran, as ``device_idle.serve`` reads it."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.device_idle(outcome)
