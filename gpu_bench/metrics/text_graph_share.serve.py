"""Share (%) of the T5 encoder's forwards that ran as a replay of a CUDA
graph: the program's counters ``text.graph_replays`` over
``text.forwards``, over the whole run (set-up's calls, the window and the
traced stretch). A program that counts neither reads nothing."""

from gpu_bench import program_trace


def read(ctx, outcome):
    share = program_trace.ratio("text.graph_replays", "text.forwards")
    return None if share is None else 100.0 * share
