"""How much more than an even share the busiest expert takes: the
program's counters ``moe.busiest_rows`` (the sum over MoE calls of the
busiest expert's rows) over ``moe.rows`` (rows routed, top-k counted),
times the number of routed experts, over the whole run. 1 is an even
split. A program that counts neither reads nothing."""

from gpu_bench import program_trace


def read(ctx, outcome):
    share = program_trace.ratio("moe.busiest_rows", "moe.rows")
    return None if share is None else share * ctx.cfg["n_routed_experts"]
