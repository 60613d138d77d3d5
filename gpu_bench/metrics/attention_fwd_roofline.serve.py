"""Share (%) of its roofline that kernel 1's forward reaches in a served
forward: the bound of the calls the configuration fixes (q, k, v read
once, the output written once; 4 B H Sq Sk D operations) over the device
time of kernel 1's forward kernels, found by name
(``readers.ATTENTION_FWD``: the port has no range around the op yet)."""

from gpu_bench import peaks, readers


def read(ctx, outcome):
    return readers.roofline(outcome, readers.ATTENTION_FWD,
                            ctx.part.attention_calls(ctx.cfg),
                            peaks.attention_fwd)
