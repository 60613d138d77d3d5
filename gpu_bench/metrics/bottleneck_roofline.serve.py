"""Share (%) of its roofline that the fused ResNet-50 blocks of stages 0-1
reach: the sum of each block's bound (``peaks.bottleneck``: its bytes at
3.35e12 B/s or its operations at 989e12, the larger) over the device time
of what the host launched inside the harness's ``bottleneck`` ranges: a
span around each block's ``forward_fused`` call (kernel 2's path, which
passes by the module's hooks) or from its module forward's pre-hook to
its hook (the plain path), so whatever implements the block."""

from gpu_bench import peaks


def read(ctx, outcome):
    profile = outcome.get("profile")
    count = getattr(ctx.part, "bottleneck_blocks", None)
    blocks = count(ctx.cfg) if count else []
    n = outcome["stretch"].get("forwards", 0)
    if profile is None or not blocks or not n:
        return None
    seconds, ops = profile.range_device_seconds("bottleneck")
    if not ops or not seconds:
        return None
    bound = sum(peaks.bound_s(*peaks.bottleneck(b, outcome["batch"]))
                for b in blocks)
    return 100.0 * n * bound / seconds
