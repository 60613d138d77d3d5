"""The served forward's model FLOPs per pair (the configuration's count)
times the pairs per second of the traced run's untraced stretch, as a
share (%) of the H100's dense bf16 peak (989e12 FLOP/s)."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.mfu(ctx, outcome)
