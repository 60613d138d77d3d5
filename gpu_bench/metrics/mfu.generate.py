"""The generated answer's model FLOPs per pair (the configuration's count:
MoonViT and the projector, the prefill over the padded prompt, the cached
decode steps) times the pairs per second of the traced run's untraced
stretch, as a share (%) of the H100's dense bf16 peak (989e12 FLOP/s)."""

from gpu_bench import readers


def read(ctx, outcome):
    return readers.mfu(ctx, outcome)
