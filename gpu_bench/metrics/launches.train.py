"""Device kernel launches per training step in the profiled stretch."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.launches(outcome, "steps")
