"""Host ms per served chunk inside the program's ``collate.images`` range:
the collate's image batch (its ``load_images``, or what replaces it),
over the profiled stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.host_ms_per(ctx, outcome, "collate.images",
                                     "session.collate")
