"""What the per-layer metric readers (``metrics/<name>.py``) share. Each
reader's ``read(ctx, outcome)`` returns its number, or None where the run
has nothing for it to read (a reader never returns 0 for a share)."""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional

from gpu_bench import peaks

# kernel 1's forward routes and its backward, by kernel function name
ATTENTION_FWD = r"\battention_(tma|short|bf16|f32)\b"
ATTENTION_BWD = r"\battention_bwd_tma\b"


def mfu(ctx, outcome: Mapping) -> Optional[float]:
    """The model FLOPs of the untraced stretch's samples per second (the
    FLOPs of a sample in the cell's mode), as a share (%) of the card's
    dense bf16 peak."""
    rate = outcome.get("rate")
    if not rate:
        return None
    flops = ctx.part.flops_per_sample(ctx.cfg)
    return 100.0 * flops * rate / peaks.PEAK_FLOPS["bfloat16"]


def per_unit(outcome: Mapping, count: float, unit: str) -> Optional[float]:
    n = outcome["stretch"].get(unit, 0)
    return count / n if n and outcome.get("profile") is not None else None


def roofline(outcome: Mapping, pattern: str, calls: Iterable[Mapping],
             bound: Callable) -> Optional[float]:
    """Sum of the calls' bounds over every forward (or step) of the
    profiled stretch, over the device time of the kernels whose name
    matches ``pattern``, as %."""
    profile = outcome.get("profile")
    if profile is None:
        return None
    seconds, launches = profile.kernel_seconds(pattern)
    n = outcome["stretch"].get("forwards", 0)
    if not seconds or not n:
        return None
    total = sum(peaks.bound_s(*bound(c, outcome["batch"])) for c in calls)
    return 100.0 * n * total / seconds


def device_idle(outcome: Mapping) -> Optional[float]:
    profile = outcome.get("profile")
    if profile is None or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)


def launches(outcome: Mapping, unit: str) -> Optional[float]:
    profile = outcome.get("profile")
    if profile is None:
        return None
    return per_unit(outcome, len(profile.kernels()), unit)
