"""Share (%) of its roofline that the decode attention core reaches: the
bytes of the latent cache each decode step reads, the folded query and
the latent output (``generate.mla_decode``) of every layer and step of an
answer, once per generating call (``vqa.model.prefill`` ranges), over the
device time launched inside the program's ``op.mla_decode`` ranges,
whatever implements the op (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    return program_trace.roofline(ctx, outcome, "op.mla_decode",
                                  "model.prefill",
                                  ctx.part.mla_decode_calls(ctx.cfg),
                                  ctx.part.mla_decode(ctx.cfg))
