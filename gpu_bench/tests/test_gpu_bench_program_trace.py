"""``program_trace`` on a small synthetic Chrome trace: which ``vqa.``
range each device operation lands in (the launching thread's own ranges
first, then, for autograd's thread, the window's thread; the producer's
never in the main thread's), the idle time by range, and the readers of
the program's ranges and counters, which return None where the run has
nothing for them."""

from __future__ import annotations

import json
import os
import types

import pytest

from gpu_bench import harness, peaks, program_trace

BENCH = harness.Bench()
MAIN, AUTOGRAD, PRODUCER = 11, 22, 33
NEW = ["images_host_ms.serve", "text_host_ms.serve",
       "readback_host_ms.serve", "pageable_copy_mib.serve",
       "vision_launches.serve", "attention_fwd_op_roofline.serve",
       "attention_fwd_op_roofline.train", "attention_bwd_op_roofline.train",
       "backward_device_ms.train", "clip_device_ms.train",
       "input_starved.train"]


def _range(name, tid, ts, dur, prefix="vqa."):
    return {"ph": "X", "cat": "user_annotation", "name": prefix + name,
            "tid": tid, "ts": ts, "dur": dur}


def _launch(corr, tid, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _events(autograd_ops=True):
    events = [
        _range("window", MAIN, 0, 1000, prefix="gpu_bench."),
        _range("step.forward", MAIN, 10, 90),
        _range("op.attention", MAIN, 20, 10),
        _range("step.backward", MAIN, 100, 200),
        _range("step.optimizer", MAIN, 300, 100),
        _range("op.attention_bwd", AUTOGRAD, 150, 10),
        _range("input.copy", PRODUCER, 310, 20),
        # before the window: read by nothing
        _range("step.forward", MAIN, -50, 20),
        _launch(1, MAIN, 25), _op(1, 40, 10),          # op.attention
        _launch(2, AUTOGRAD, 120), _op(2, 130, 20),    # the backward
        _launch(3, AUTOGRAD, 155), _op(3, 160, 30),    # its kernel's range
        _launch(4, PRODUCER, 320), _op(4, 325, 5, "gpu_memcpy"),
        _launch(5, PRODUCER, 340), _op(5, 345, 5, "gpu_memcpy"),
        _launch(6, MAIN, 350), _op(6, 360, 10),        # the optimizer
    ]
    if autograd_ops:
        events.append({"ph": "X", "cat": "cpu_op", "tid": AUTOGRAD,
                       "name": "autograd::engine::evaluate_function: "
                               "MmBackward0", "ts": 110, "dur": 50})
    return events


def test_device_time_lands_in_the_launching_threads_ranges():
    s = program_trace.Stretch(_events())
    assert s.tid == MAIN and s.helpers == {AUTOGRAD}
    us = {k: round(v * 1e6, 6) for k, v in s.device_s.items()}
    assert us["op.attention"] == 10 and us["step.forward"] == 10
    # autograd's thread: its own range first, then the window's thread's
    assert us["op.attention_bwd"] == 30
    assert us["step.backward"] == 50 and s.launches["step.backward"] == 2
    # the producer's copies stay out of the main thread's range, whether
    # the profiler recorded its range or not
    assert us["input.copy"] == 5
    assert us["step.optimizer"] == 10 and s.launches["step.optimizer"] == 1
    assert s.launches["input.copy"] == 0


def test_only_autograds_thread_falls_back_to_the_window_thread():
    s = program_trace.Stretch(_events(autograd_ops=False))
    assert not s.helpers
    us = {k: round(v * 1e6, 6) for k, v in s.device_s.items()}
    assert "step.backward" not in us and us["op.attention_bwd"] == 30


def test_ranges_counted_inside_the_window_and_idle_by_innermost_range():
    s = program_trace.Stretch(_events())
    assert s.calls["step.forward"] == 1
    assert round(s.host_s["step.backward"] * 1e6, 6) == 200
    idle = {k: round(v * 1e6, 6) for k, v in s.idle_s.items()}
    assert idle == {"op.attention": 10, "step.forward": 70,
                    "step.backward": 150, "step.optimizer": 80,
                    program_trace.OUTSIDE: 610}
    assert sum(idle.values()) == 1000 - 80


def test_nested_segments():
    segs = program_trace._segments([(0, 10, "a"), (2, 4, "b"),
                                    (3, 4, "c"), (6, 8, "d")])
    assert segs == [(0, 2, ("a",)), (2, 3, ("b", "a")),
                    (3, 4, ("c", "b", "a")), (4, 6, ("a",)),
                    (6, 8, ("d", "a")), (8, 10, ("a",))]


def _ctx(cell):
    w = BENCH.workload(cell)
    mix = BENCH.mix(w["traffic"])
    return types.SimpleNamespace(
        name=cell, cfg=BENCH.config(w["config"]),
        part=BENCH.part(w["config"], BENCH.loop(mix["kind"]).MODE))


@pytest.fixture
def no_counters():
    from t5_resnet_vqa_torch.utils import profiling

    saved = profiling.counters()
    profiling.reset_counters()
    yield profiling
    profiling.reset_counters()
    for k, v in saved.items():
        profiling.count(k, v)


@pytest.mark.parametrize("metric", NEW)
def test_readers_return_none_without_a_profile(metric, no_counters):
    entry = next(m for m in BENCH.spec["per_layer"] if m["name"] == metric)
    assert entry["workloads"]
    for cell in entry["workloads"]:
        outcome = {"profile": None, "batch": 4, "stretch": {}}
        assert BENCH.reader(metric).read(_ctx(cell), outcome) is None


def test_readers_read_the_cells_trace(tmp_path, monkeypatch, no_counters):
    cell = "cross.train"
    os.makedirs(tmp_path / "traces")
    with open(tmp_path / "traces" / f"{cell}.trace.json", "w") as f:
        json.dump({"traceEvents": _events()}, f)
    monkeypatch.setattr(harness, "OUT_DIR", str(tmp_path))
    ctx = _ctx(cell)
    outcome = {"profile": object(), "batch": 4, "stretch": {}}
    read = lambda m: BENCH.reader(m).read(ctx, outcome)
    assert read("backward_device_ms.train") == pytest.approx(0.05)
    assert read("clip_device_ms.train") is None       # no step.clip range
    bound = sum(peaks.bound_s(*peaks.attention_bwd(c, 4))
                for c in ctx.part.attention_bwd_calls(ctx.cfg))
    assert read("attention_bwd_op_roofline.train") == pytest.approx(
        100 * bound / 30e-6)
    assert read("input_starved.train") is None        # no counter yet
    no_counters.count("input.waits", 8)
    no_counters.count("input.waits_empty", 2)
    assert read("input_starved.train") == pytest.approx(25.0)
    no_counters.count("session.chunks", 2)
    no_counters.count("session.pageable_bytes", 3 * 2 ** 20)
    assert BENCH.reader("pageable_copy_mib.serve").read(
        _ctx("cnn.serve"), outcome) == pytest.approx(1.5)


def test_a_trace_without_program_ranges_reads_none(tmp_path):
    path = tmp_path / "t.json"
    events = [e for e in _events() if not e["name"].startswith("vqa.")]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert program_trace.read(str(path)) is None
