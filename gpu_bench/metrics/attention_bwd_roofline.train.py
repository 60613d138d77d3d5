"""Share (%) of its roofline that kernel 1's backward reaches in a
training step: q, k, v and the gradient read once, dq, dk, dv written
once, five products (``peaks.attention_bwd``), over the device time of
the backward kernel, found by name (``readers.ATTENTION_BWD``)."""

from gpu_bench import peaks, readers


def read(ctx, outcome):
    return readers.roofline(outcome, readers.ATTENTION_BWD,
                            ctx.part.attention_bwd_calls(ctx.cfg),
                            peaks.attention_bwd)
