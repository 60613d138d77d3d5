"""Share (%) of its roofline that kernel 1's forward op reaches in a
training step: the bound of the step's forward calls (RoBERTa's also
write the rows' statistics) once per ``step.forward`` range, over the
device time inside the program's ``op.attention`` ranges
(``program_trace``)."""

from gpu_bench import peaks, program_trace


def read(ctx, outcome):
    return program_trace.roofline(ctx, outcome, "op.attention",
                                  "step.forward",
                                  ctx.part.attention_calls(ctx.cfg),
                                  peaks.attention_fwd)
