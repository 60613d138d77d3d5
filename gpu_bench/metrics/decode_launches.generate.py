"""Kernels launched inside the program's ``model.decode`` ranges per
decode step, over the profiled stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.launches_per(ctx, outcome, "model.decode",
                                      "model.decode")
