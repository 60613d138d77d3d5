"""Device ms per cached decode step: what the program launched inside its
``model.decode`` ranges (one a step) over their number, in the profiled
stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.device_ms_per(ctx, outcome, "model.decode",
                                       "model.decode")
