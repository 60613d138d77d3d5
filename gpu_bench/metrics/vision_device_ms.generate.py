"""Device ms per generating call (one chunk, one ``vqa.session.collate``
range) launched inside the program's ``model.vision`` ranges: MoonViT and
the projector, over the profiled stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.device_ms_per(ctx, outcome, "model.vision",
                                       "session.collate")
