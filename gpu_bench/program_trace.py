"""The program's own ranges in a profiled stretch: the ``vqa.`` ranges that
the port opens (``t5_resnet_vqa_torch/utils/profiling.py``) while a
profiler records, read from the Chrome trace that ``Ctx.profile`` writes
(``out/traces/<cell>.trace.json``), and the program's counters.

``Stretch`` keeps the ``vqa.`` ranges of every thread that lie in the
``gpu_bench.window`` range, and puts each device operation down, through
its launch's correlation id, to the ranges open on its launching thread
at launch time:

* the ranges of the launching thread, innermost first;
* on a thread that runs autograd's engine for another (the profiler
  records its ``autograd::engine::evaluate_function`` operators), then
  the ranges open at that time on the thread that opened the window: a
  backward's launches land in ``step.backward``, and a kernel's backward
  range there in both;
* no other thread's: the input pipeline's producer runs beside the step,
  so its copies never land in a range of the main thread. (A profiler
  records ranges only on the threads it follows: the thread that starts
  it and autograd's, unless it is told to follow every thread. Under the
  harness's profiler the producer's copies land in no range at all.)

Per range name it gives the host seconds and the number of ranges, and
the device seconds and kernel launches of the operations launched inside
any range of that name; and the device's idle time in the window by the
innermost ``vqa.`` range open on the window's thread.

    python3 -m gpu_bench.program_trace gpu_bench/out/traces/cnn.serve.trace.json

prints them for a trace.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import sys
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from gpu_bench import harness, peaks
from gpu_bench.trace import DEVICE_CATS, LAUNCH_CATS, PREFIX

PROGRAM = "vqa."
WINDOW = PREFIX + "window"
AUTOGRAD = "autograd::engine::evaluate_function"
OUTSIDE = "outside any vqa. range"
MIB = 2 ** 20

Segment = Tuple[float, float, Tuple[str, ...]]


def _segments(ranges: Iterable[Tuple[float, float, str]]) -> List[Segment]:
    """One thread's nested ranges as consecutive segments, each with the
    names open over it, innermost first."""
    segments: List[Segment] = []
    stack: List[Tuple[float, str]] = []         # (end, name), outermost first
    at = 0.0

    def close_to(t: float) -> None:
        nonlocal at
        if stack and t > at:
            segments.append((at, t, tuple(n for _, n in reversed(stack))))
        at = max(at, t)

    for start, end, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= start:
            close_to(stack[-1][0])
            stack.pop()
        close_to(start)
        stack.append((end, name))
    while stack:
        close_to(stack[-1][0])
        stack.pop()
    return segments


class _Timeline:
    """The names open on one thread at any time."""

    def __init__(self, ranges: Iterable[Tuple[float, float, str]]):
        self.segments = _segments(ranges)
        self.starts = [s[0] for s in self.segments]

    def at(self, t: float) -> Tuple[str, ...]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.segments[i][0] <= t < self.segments[i][1]:
            return self.segments[i][2]
        return ()


class Stretch:
    """The ``vqa.`` ranges and the device operations of one profiled
    stretch."""

    def __init__(self, events: List[dict]):
        ranges: Dict[int, List[Tuple[float, float, str]]] = \
            collections.defaultdict(list)
        launched: Dict[int, Tuple[int, float]] = {}
        ops = []
        self.helpers = set()
        self.tid, self.t0, self.t1 = None, 0.0, 0.0
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            args = e.get("args") or {}
            ts = float(e["ts"])
            if cat == "user_annotation" and name == WINDOW:
                self.tid, self.t0, self.t1 = e["tid"], ts, ts + float(e["dur"])
            elif cat == "user_annotation" and name.startswith(PROGRAM):
                ranges[e["tid"]].append((ts, ts + float(e["dur"]),
                                         name[len(PROGRAM):]))
            elif cat == "cpu_op" and name.startswith(AUTOGRAD):
                self.helpers.add(e["tid"])
            elif cat in LAUNCH_CATS and "correlation" in args:
                launched[args["correlation"]] = (e["tid"], ts)
            elif cat in DEVICE_CATS:
                ops.append((cat, ts, float(e["dur"]), args.get("correlation")))
        self.helpers.discard(self.tid)
        inside = lambda t: self.t0 <= t <= self.t1
        self.host_s: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)
        for spans in ranges.values():
            for start, end, name in spans:
                if inside(start):
                    self.host_s[name] += (end - start) / 1e6
                    self.calls[name] += 1
        lines = {tid: _Timeline(spans) for tid, spans in ranges.items()}
        empty = _Timeline(())
        main = lines.get(self.tid, empty)
        self.device_s: Dict[str, float] = collections.defaultdict(float)
        self.launches: Dict[str, int] = collections.defaultdict(int)
        busy = []
        for cat, ts, dur, corr in ops:
            if ts < self.t1 and ts + dur > self.t0:
                busy.append((max(ts, self.t0), min(ts + dur, self.t1)))
            launch = launched.get(corr)
            if launch is None or not inside(launch[1]):
                continue
            tid, t = launch
            names = lines.get(tid, empty).at(t)
            if tid in self.helpers:
                names += main.at(t)
            for name in set(names):
                self.device_s[name] += dur / 1e6
                self.launches[name] += cat == "kernel"
        self.idle_s = self._idle(busy, main)

    def _idle(self, busy, main: _Timeline) -> Dict[str, float]:
        """Seconds of the window in which no device operation ran, by the
        innermost range open on the window's thread."""
        gaps, at = [], self.t0
        for a, b in sorted(busy):
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        idle: Dict[str, float] = collections.defaultdict(float)
        segments = main.segments
        for a, b in gaps:
            covered = 0.0
            i = max(0, bisect.bisect_right(main.starts, a) - 1)
            while i < len(segments) and segments[i][0] < b:
                s, e, names = segments[i]
                overlap = min(b, e) - max(a, s)
                if overlap > 0:
                    idle[names[0]] += overlap / 1e6
                    covered += overlap
                i += 1
            idle[OUTSIDE] += (b - a - covered) / 1e6
        return dict(idle)

    def per(self, name: str, unit: str) -> Optional[Tuple[float, float]]:
        """(host seconds, device seconds) in ranges ``name`` per range
        ``unit``, or None where either is missing."""
        n = self.calls.get(unit, 0)
        if not n or name not in self.calls:
            return None
        return self.host_s[name] / n, self.device_s.get(name, 0.0) / n

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"ranges": self.calls[name],
                       "host_ms": 1e3 * self.host_s[name],
                       "device_ms": 1e3 * self.device_s.get(name, 0.0),
                       "kernels": self.launches.get(name, 0),
                       "idle_ms": 1e3 * self.idle_s.get(name, 0.0)}
                for name in sorted(self.calls)}


_cache: Dict[Tuple[str, float], Optional[Stretch]] = {}


def read(path: str) -> Optional[Stretch]:
    """The stretch of the trace at ``path``; None where it has no window
    or no ``vqa.`` range (a program without them)."""
    key = (path, os.path.getmtime(path))
    if key not in _cache:
        with open(path) as f:
            stretch = Stretch(json.load(f)["traceEvents"])
        _cache.clear()
        _cache[key] = stretch if stretch.tid is not None \
            and stretch.calls else None
    return _cache[key]


def load(ctx, outcome: Mapping) -> Optional[Stretch]:
    """This run's profiled stretch, or None without one."""
    if outcome.get("profile") is None:
        return None
    path = os.path.join(harness.OUT_DIR, "traces", f"{ctx.name}.trace.json")
    return read(path) if os.path.exists(path) else None


def counters() -> Optional[Dict[str, int]]:
    """The program's counters, or None where it has none."""
    try:
        from t5_resnet_vqa_torch.utils import profiling
    except ImportError:
        return None
    read_them = getattr(profiling, "counters", None)
    return read_them() if read_them else None


def ratio(numerator: str, denominator: str) -> Optional[float]:
    """One counter over another (a counter never counted reads 0), None
    where the program has no counters or the denominator is 0."""
    got = counters()
    if not got or not got.get(denominator):
        return None
    return got.get(numerator, 0) / got[denominator]


def host_ms_per(ctx, outcome: Mapping, name: str, unit: str
                ) -> Optional[float]:
    stretch = load(ctx, outcome)
    got = stretch.per(name, unit) if stretch else None
    return 1e3 * got[0] if got else None


def device_ms_per(ctx, outcome: Mapping, name: str, unit: str
                  ) -> Optional[float]:
    stretch = load(ctx, outcome)
    got = stretch.per(name, unit) if stretch else None
    return 1e3 * got[1] if got and got[1] else None


def launches_per(ctx, outcome: Mapping, name: str, unit: str
                 ) -> Optional[float]:
    stretch = load(ctx, outcome)
    n = stretch.calls.get(unit, 0) if stretch else 0
    if not n or name not in stretch.calls:
        return None
    return stretch.launches.get(name, 0) / n


def roofline(ctx, outcome: Mapping, name: str, unit: str,
             calls: Iterable[Mapping], bound) -> Optional[float]:
    """The calls' bounds (per sample, times the batch) once per range
    ``unit``, over the device seconds inside the ranges ``name``, as %."""
    stretch = load(ctx, outcome)
    n = stretch.calls.get(unit, 0) if stretch else 0
    seconds = stretch.device_s.get(name, 0.0) if stretch else 0.0
    if not n or not seconds:
        return None
    total = sum(peaks.bound_s(*bound(c, outcome["batch"])) for c in calls)
    return 100.0 * n * total / seconds


def main(argv=None) -> int:
    for path in (argv if argv is not None else sys.argv[1:]):
        stretch = read(path)
        if stretch is None:
            print(f"{path}: no vqa. range in a window")
            continue
        print(json.dumps({"trace": path,
                          "window_ms": (stretch.t1 - stretch.t0) / 1e3,
                          "ranges": stretch.summary(),
                          "idle_ms": {k: 1e3 * v for k, v in sorted(
                              stretch.idle_s.items(),
                              key=lambda kv: -kv[1])}}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
