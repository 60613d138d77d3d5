"""Host ms per served chunk inside the program's ``session.readback``
range: the host blocked on the chunk's results (``.cpu()``), over the
profiled stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.host_ms_per(ctx, outcome, "session.readback",
                                     "session.collate")
