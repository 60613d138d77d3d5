"""Share (%) of its roofline that kernel 1's forward reaches in a
training step (RoBERTa's calls also write the rows' statistics), found by
kernel name as in ``attention_fwd_roofline.serve``."""

from gpu_bench import peaks, readers


def read(ctx, outcome):
    return readers.roofline(outcome, readers.ATTENTION_FWD,
                            ctx.part.attention_calls(ctx.cfg),
                            peaks.attention_fwd)
