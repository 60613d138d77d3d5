"""Device ms per training step of what the backward launches: the
operations launched inside the program's ``step.backward`` range, by the
main thread or by autograd's, over the profiled stretch
(``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.device_ms_per(ctx, outcome, "step.backward",
                                       "step.backward")
