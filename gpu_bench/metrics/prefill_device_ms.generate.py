"""Device ms per generating call (one chunk, one ``vqa.session.collate``
range) launched inside the program's ``model.prefill`` ranges: the
decoder over the whole prompt, the cache written and the first token's
logits, over the profiled stretch (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.device_ms_per(ctx, outcome, "model.prefill",
                                       "session.collate")
