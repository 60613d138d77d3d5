"""Device ms per training step of the gradient clip: the operations
launched inside the program's ``step.clip`` range, over the profiled
stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.device_ms_per(ctx, outcome, "step.clip",
                                       "step.clip")
