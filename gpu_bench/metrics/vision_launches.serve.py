"""Kernels launched inside the program's ``model.vision`` ranges (the
ResNet tower; the ViT embeddings and layers) per served forward (the
``session.forward`` ranges), over the profiled stretch
(``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.launches_per(ctx, outcome, "model.vision",
                                      "session.forward")
