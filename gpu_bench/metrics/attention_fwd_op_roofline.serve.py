"""Share (%) of its roofline that kernel 1's forward op reaches in a
served forward: the bound of the calls the configuration fixes
(``peaks.attention_fwd``) once per ``session.forward`` range, over the
device time launched inside the program's ``op.attention`` ranges, so
whatever route or kernel implements the op (``program_trace``)."""

from gpu_bench import peaks, program_trace


def read(ctx, outcome):
    return program_trace.roofline(ctx, outcome, "op.attention",
                                  "session.forward",
                                  ctx.part.attention_calls(ctx.cfg),
                                  peaks.attention_fwd)
