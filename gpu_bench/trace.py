"""The traced run's instruments: host spans the harness puts around its
calls into the program, and a profiled stretch read from the device trace.

``Tracer.span`` times a call into a layer on the host clock (seconds and
calls by name); while a stretch is profiled it also opens a
``record_function`` range ``gpu_bench.<name>``, so that the trace can say
which device work each span launched. ``profile`` runs a stretch under
``torch.profiler`` (CPU and CUDA activities), writes its Chrome trace
under ``gpu_bench/out/`` and reads it into a ``Profile``:

* device operations (kernels, copies, sets) with their times and, through
  the launch's correlation id, the host time of their launch;
* the harness's ranges;
* the window (the ``gpu_bench.window`` range around the stretch, which
  ends after a synchronisation), the busy time (the union of the device
  operations inside it) and the breakdown: the busiest device operations,
  and the idle gaps by the innermost harness range the host was in.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "gpu_bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRIES = 3


class Tracer:
    """Host spans by name; ``enabled`` False makes every span free."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)
        self._open: Dict[str, list] = collections.defaultdict(list)

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()

    def open(self, name: str) -> None:
        if not self.enabled:
            return
        rf = None
        if self.profiling:
            import torch
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
        self._open[name].append((time.perf_counter(), rf))

    def close(self, name: str) -> None:
        if not self.enabled or not self._open[name]:
            return
        t0, rf = self._open[name].pop()
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1
        if rf is not None:
            rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        self.open(name)
        try:
            yield
        finally:
            self.close(name)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put a span around ``obj.attr(...)`` (an instance attribute that
        shadows the method)."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, spanned)

    def hook_module(self, module, name: str) -> None:
        """A span from each forward's pre-hook to its hook."""
        if not self.enabled:
            return
        module.register_forward_pre_hook(lambda m, a: self.open(name))
        module.register_forward_hook(lambda m, a, o: self.close(name))


class Profile:
    """One profiled stretch, read from its Chrome trace."""

    def __init__(self, events: List[dict]):
        self.ranges: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        launches: Dict[int, float] = {}
        ops = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                self.ranges[e["name"][len(PREFIX):]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = float(e["ts"])
            elif cat in DEVICE_CATS:
                ops.append((e["name"], cat, float(e["ts"]), float(e["dur"]),
                            args.get("correlation")))
        for spans in self.ranges.values():
            spans.sort()
        windows = self.ranges.get("window") or [(0.0, 0.0)]
        self.t0, self.t1 = windows[0]
        # (name, category, start us, duration us, host launch us or None)
        self.ops = [(n, c, ts, dur, launches.get(corr))
                    for n, c, ts, dur, corr in ops
                    if ts < self.t1 and ts + dur > self.t0]
        self.busy = self._union([(ts, ts + dur)
                                 for _, _, ts, dur, _ in self.ops])

    def _union(self, spans):
        merged: List[List[float]] = []
        for a, b in sorted(spans):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernels(self) -> list:
        return [op for op in self.ops if op[1] == "kernel"]

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [op for op in self.kernels() if rx.search(op[0])]
        return sum(op[3] for op in hits) / 1e6, len(hits)

    def _inside(self, name: str, t: Optional[float]) -> bool:
        spans = self.ranges.get(name, [])
        if t is None or not spans:
            return False
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def range_device_seconds(self, name: str) -> Tuple[float, int]:
        """(device seconds, operations) of what the host launched inside
        the harness range ``name``."""
        hits = [op for op in self.ops if self._inside(name, op[4])]
        return sum(op[3] for op in hits) / 1e6, len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = collections.defaultdict(float)
        for name, _, _, dur, _ in self.ops:
            by_op[name[:120]] += dur / 1e6
        gaps: Dict[str, float] = collections.defaultdict(float)
        edges = [self.t0] + [x for span in self.busy for x in span] \
            + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self._host_range((a + b) / 2)] += (b - a) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}

    def _host_range(self, t: float) -> str:
        best, width = "outside any harness range", float("inf")
        for name, spans in self.ranges.items():
            if name == "window":
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1] \
                    and spans[i][1] - spans[i][0] < width:
                best, width = PREFIX + name, spans[i][1] - spans[i][0]
        return best


def profile(tracer: Tracer, stretch: Callable[[], None], path: str
            ) -> Profile:
    """Run ``stretch`` under the profiler, write its Chrome trace to
    ``path`` and read it back. The profiler now and then returns a stretch
    without device rows; such a stretch is run again, up to TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    for _ in range(TRIES):
        torch.cuda.synchronize()
        tracer.profiling = True
        try:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                with torch.autograd.profiler.record_function(
                        PREFIX + "window"):
                    stretch()
                    torch.cuda.synchronize()
        finally:
            tracer.profiling = False
        prof.export_chrome_trace(path)
        with open(path) as f:
            result = Profile(json.load(f)["traceEvents"])
        if result.busy_s > 0:
            return result
    raise RuntimeError(f"the profiler saw no device operation in {TRIES} "
                       f"stretches")
