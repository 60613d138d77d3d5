"""Device ms per step of what ``optimizer.step`` launches: the operations
launched inside the range that the optimizer's step pre- and post-hooks
open and close, in the profiled stretch."""


def read(ctx, outcome):
    profile = outcome.get("profile")
    steps = outcome["stretch"].get("steps", 0)
    if profile is None or not steps:
        return None
    seconds, ops = profile.range_device_seconds("optimizer")
    return 1e3 * seconds / steps if ops else None
