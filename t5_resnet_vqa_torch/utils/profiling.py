"""Profiling and tracing utilities (the JAX package's ``utils/profiling.py``).

The reference's only observability is wall-clock secs/batch logging
(faster_rcnn_vqa_trainer.py:331-339). The trainer keeps that log format and
adds real tracing:

  * ``trace(logdir)`` — context manager around ``torch.profiler`` over the
    CPU and, where a card is present, CUDA activities, writing a Chrome
    trace (``trace_<pid>.json``, viewable in Perfetto or
    chrome://tracing) into ``logdir``;
  * ``StepTimer`` — rolling secs/step with the reference's 10%-interval
    averaging semantics, host-side only.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block and write its Chrome trace into ``logdir``; yields
    the trace's path. Device activity is traced when CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """Accumulates per-step wall time; windows reset on read (the
    reference's ten-percent-interval pattern, trainer :331-363)."""

    def __init__(self):
        self.window_time = 0.0
        self.window_steps = 0
        self.total_time = 0.0
        self.total_steps = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self._t0
        self.window_time += dt
        self.window_steps += 1
        self.total_time += dt
        self.total_steps += 1
        return False

    def window_average(self) -> float:
        avg = self.window_time / max(1, self.window_steps)
        self.window_time = 0.0
        self.window_steps = 0
        return avg

    def total_average(self) -> float:
        return self.total_time / max(1, self.total_steps)
