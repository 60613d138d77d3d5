"""Share (%) of its roofline that kernel 1's backward op reaches in a
training step: the bound of the step's backward calls
(``peaks.attention_bwd``) once per ``step.backward`` range, over the
device time inside the program's ``op.attention_bwd`` ranges, which
autograd's thread opens (``program_trace``)."""

from gpu_bench import peaks, program_trace


def read(ctx, outcome):
    return program_trace.roofline(ctx, outcome, "op.attention_bwd",
                                  "step.backward",
                                  ctx.part.attention_bwd_calls(ctx.cfg),
                                  peaks.attention_bwd)
