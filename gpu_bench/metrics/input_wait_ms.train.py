"""Host ms per step that the training loop waits for the prefetcher's
next batch (the harness's span around ``next()`` over the untraced
stretch of the traced run)."""


def read(ctx, outcome):
    host = outcome["host"]
    steps = host["calls"].get("input_wait", 0)
    if not steps:
        return None
    return 1e3 * host["seconds"]["input_wait"] / steps
