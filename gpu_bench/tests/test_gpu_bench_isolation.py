"""The isolation check compares top-level module names whole, the
references import nothing of the program, and a run loads no JAX."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from gpu_bench import harness


def test_top_level_names_compared_whole():
    modules = {"t5_resnet_vqa_torch": 1, "t5_resnet_vqa_torch.ops": 1,
               "jax_utils": 1, "jaxlibrary": 1, "numpy": 1}
    assert harness.forbidden_modules(modules) == []
    modules.update({"t5_resnet_vqa_tpu.models.t5": 1, "jaxlib.xla": 1})
    assert harness.forbidden_modules(modules) == ["jaxlib",
                                                  "t5_resnet_vqa_tpu"]
    assert harness.forbidden_modules({"jax": 1, "flax.linen": 1}) == \
        ["flax", "jax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"t5_resnet_vqa_torch", *harness.FORBIDDEN}, f


def test_harness_imports_no_jax_package():
    for dirpath, dirs, files in os.walk(harness.BENCH_DIR):
        if dirpath == harness.BENCH_DIR and "out" in dirs:
            dirs.remove("out")  # what runs write, not the harness
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0]
                        for m in _imports(os.path.join(dirpath, f))}
                assert not tops & set(harness.FORBIDDEN), f


def test_a_run_loads_no_jax():
    code = ("import torch; torch.set_num_threads(2)\n"
            "from gpu_bench.tests import tiny\n"
            "from gpu_bench.run import run_cell\n"
            "from gpu_bench import harness\n"
            "run_cell(tiny.ctx('cross.serve', seconds=0.2))\n"
            "print(harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("USE_FLAX", "USE_JAX")}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "gpu_bench.run", "--workload", "cross.serve",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
