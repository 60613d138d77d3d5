"""A training step's model FLOPs per sample (the configuration's count:
the frozen forward, the trained part's forward and backward, nothing
recomputed) times the samples per second of the traced run's untraced
stretch, as a share (%) of the H100's dense bf16 peak."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.mfu(ctx, outcome)
