"""Host ms per served chunk inside the program's ``collate.text`` range:
tokenising the chunk's questions, over the profiled stretch
(``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.host_ms_per(ctx, outcome, "collate.text",
                                     "session.collate")
