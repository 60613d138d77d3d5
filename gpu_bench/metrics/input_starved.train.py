"""Share (%) of the training loop's takes from the prefetcher's queue
that found it empty, so that the step waited for the producer: the
program's counters ``input.waits_empty`` over ``input.waits``, over the
whole run (set-up's steps, the window and the traced stretch)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    share = program_trace.ratio("input.waits_empty", "input.waits")
    return None if share is None else 100.0 * share
