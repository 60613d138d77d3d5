"""Share (%) of its roofline that the sparse-expert op reaches: the least
seconds of the stretch's MoE layers (``generate.moe_bound_s``: routed,
shared and router products from the program's ``moe.rows``, and every
expert's weights read once a layer, from the counters over the profiled
stretch) over the device time launched inside the program's ``op.moe``
ranges, whatever implements the op (``program_trace``)."""

from gpu_bench import program_trace


def read(ctx, outcome):
    stretch = program_trace.load(ctx, outcome)
    seconds = stretch.device_s.get("op.moe", 0.0) if stretch else 0.0
    counts = outcome.get("stretch_counters")
    if not seconds or not counts:
        return None
    bound = ctx.part.moe_bound_s(ctx.cfg, counts, outcome["batch"])
    return None if bound is None else 100.0 * bound / seconds
