"""MiB per served chunk that the session copies to the card from pageable
host memory: the program's counters ``session.pageable_bytes`` over
``session.chunks``, over the whole run (every chunk has the same
arrays)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    share = program_trace.ratio("session.pageable_bytes", "session.chunks")
    return share / program_trace.MIB if share else None
