"""Device kernel launches per served forward in the profiled stretch."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.launches(outcome, "forwards")
