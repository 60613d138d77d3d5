"""A later change adds a cell, a configuration, a mode of a configuration
that is there, a traffic mix and a per-layer metric as new files and new
entries: the harness finds them by name, with no edit to a file that is
there."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpu_bench import harness
from gpu_bench.run import Ctx, per_layer, run_cell
from gpu_bench.tests import tiny

METRIC = '''
def read(ctx, outcome):
    return outcome["counts"]["calls"] / outcome["counts"]["window_s"]
'''


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark with one configuration, mix, metric, limits
    file and cell added beside what is there, and a cell of a new mode
    (its loop, its traffic and the existing CNN configuration's file for
    that mode)."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "gpu_bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = {p: (root / "gpu_bench" / p).read_bytes()
              for p in ("harness.py", "run.py", "generate.py",
                        "configs/cnn_resnet50_t5base/model.py",
                        "configs/cnn_resnet50_t5base/serve.py")}
    bench = harness.Bench(str(root), str(root / "gpu_bench"))
    cfg = tiny.config(bench, "cross_vitbase_robertabase")
    cfg["name"] = "cross_small"
    new_cfg = root / "gpu_bench" / "configs" / "cross_small"
    shutil.copytree(root / "gpu_bench" / "configs" /
                    "cross_vitbase_robertabase", new_cfg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (new_cfg / "config.json").write_text(json.dumps(cfg))
    # a new mode of the CNN configuration: its loop, its traffic, its file
    loops = root / "gpu_bench" / "loops"
    (loops / "serve_again.py").write_text(
        (loops / "serve_closed.py").read_text().replace(
            'MODE = "serve"', 'MODE = "serve_again"'))
    cnn = root / "gpu_bench" / "configs" / "cnn_resnet50_t5base"
    shutil.copy(cnn / "serve.py", cnn / "serve_again.py")
    again = tiny.mix(bench, "serve_closed_b256_x512")
    again["kind"] = "serve_again"
    (root / "gpu_bench" / "traffic" / "serve_again_b4_x8.json").write_text(
        json.dumps(again))
    (root / "gpu_bench" / "limits" / "cnn.again.json").write_text(
        json.dumps(tiny.TINY_LIMITS["serve_closed"]))
    mix = tiny.mix(bench, "serve_closed_b64_x256")
    (root / "gpu_bench" / "traffic" / "serve_closed_b4_x8.json").write_text(
        json.dumps(mix))
    (root / "gpu_bench" / "metrics" / "calls_per_s.serve.py").write_text(
        METRIC)
    (root / "gpu_bench" / "limits" / "small.serve.json").write_text(
        json.dumps(tiny.TINY_LIMITS["serve_closed"]))
    spec = copy.deepcopy(bench.spec)
    spec["configs"].append({"name": "cross_small", "source": "a test",
                            "file": "gpu_bench/configs/cross_small/"
                                    "config.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "small.serve", "config": "cross_small",
                              "traffic": "serve_closed_b4_x8", "chips": 1,
                              "why": "a test"})
    spec["workloads"].append({"name": "cnn.again",
                              "config": "cnn_resnet50_t5base",
                              "traffic": "serve_again_b4_x8", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "serve_pairs_per_s" == m["name"]:
            m["workloads"] += ["small.serve", "cnn.again"]
    spec["per_layer"].append({"name": "calls_per_s.serve", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "Session",
                              "moves": "serve_pairs_per_s",
                              "workloads": ["small.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    yield root
    for p, data in before.items():
        assert (root / "gpu_bench" / p).read_bytes() == data


def test_new_cell_found_and_run(grown):
    bench = harness.Bench(str(grown), str(grown / "gpu_bench"))
    assert [m["name"] for m in bench.per_layer("small.serve")] == \
        ["calls_per_s.serve"]
    assert [m["name"] for m in bench.end_to_end("small.serve")] == \
        ["serve_pairs_per_s", "peak_device_mib", "setup_s"]
    ctx = Ctx(bench, "small.serve", 2 ** 31 + 11, 0.3, False,
              torch.device("cpu"))
    outcome = run_cell(ctx)
    assert outcome["correct"], outcome["checks"]
    assert per_layer(ctx, outcome)["calls_per_s.serve"]["value"] > 0


def test_new_mode_of_a_config_found_and_run(grown):
    bench = harness.Bench(str(grown), str(grown / "gpu_bench"))
    w = bench.workload("cnn.again")
    ctx = Ctx(bench, "cnn.again", 2 ** 31 + 13, 0.3, False,
              torch.device("cpu"), cfg=tiny.config(bench, w["config"]),
              mix=bench.mix(w["traffic"]))
    assert ctx.loop.MODE == "serve_again"
    assert ctx.part.flops_per_sample(ctx.cfg) > 0
    outcome = run_cell(ctx)
    assert outcome["correct"], outcome["checks"]


def test_benchmark_alone_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails for want of the program."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    code = ("from gpu_bench.tests import tiny\n"
            "from gpu_bench.run import run_cell\n"
            "run_cell(tiny.ctx('cross.serve', seconds=0.2))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0
    assert "t5_resnet_vqa_torch" in out.stderr
