"""What every cell shares: finding its pieces by name, the seeds, the
weights the benchmark draws, the device's description, and the check that
the JAX package never loaded.

Layout, all found by the names in ``BENCHMARK.json``:

* ``configs/<config>/config.json`` (sizes, source, ``assumed``),
  ``configs/<config>/model.py`` (builds the program's model, names its
  plain reference in ``reference/``) and ``configs/<config>/<mode>.py``
  for each mode the configuration runs in (``serve``, ``train``: the
  loop's ``MODE``): the FLOPs and kernel call shapes of that mode, and
  its reference step;
* ``traffic/<traffic>.json``: a mix's parameters, read by ``generate.py``
  and run by ``loops/<kind>.py``, ``kind`` being the mix's;
* ``metrics/<metric>.py``: a per-layer metric's reader;
* ``limits/<workload>.json``: the limits of the numbers that decide a
  cell's ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
OUT_DIR = os.path.join(BENCH_DIR, "out")
FORBIDDEN = ("jax", "jaxlib", "flax", "t5_resnet_vqa_tpu")
MIB = 2 ** 20


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def beside(file: str, name: str) -> ModuleType:
    """The module ``<name>.py`` in the directory of ``file``: a mode's
    file loads its configuration's ``model.py`` so."""
    folder = os.path.dirname(os.path.abspath(file))
    return _module(os.path.join(folder, f"{name}.py"),
                   f"gpu_bench_{os.path.basename(folder)}_{name}"
                   .replace(".", "_").replace("-", "_"))


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root = root
        self.dir = bench_dir
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> Mapping:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Mapping:
        return load_json(os.path.join(self.dir, "configs", name,
                                      "config.json"))

    def model(self, name: str) -> ModuleType:
        return _module(os.path.join(self.dir, "configs", name, "model.py"),
                       f"gpu_bench_config_{name.replace('.', '_')}")

    def part(self, name: str, mode: str) -> ModuleType:
        """What configuration ``name`` needs in ``mode``: its counts and
        its reference step (``configs/<name>/<mode>.py``)."""
        path = os.path.join(self.dir, "configs", name, f"{mode}.py")
        if not os.path.exists(path):
            raise KeyError(f"configuration {name!r} has no {mode!r} mode "
                           f"(configs/{name}/{mode}.py)")
        return _module(path, f"gpu_bench_config_{name}_{mode}"
                       .replace(".", "_").replace("-", "_"))

    def mix(self, name: str) -> Mapping:
        return load_json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def loop(self, kind: str) -> ModuleType:
        return _module(os.path.join(self.dir, "loops", f"{kind}.py"),
                       f"gpu_bench_loop_{kind}")

    def limits(self, workload: str) -> Optional[Mapping]:
        path = os.path.join(self.dir, "limits", f"{workload}.json")
        return load_json(path) if os.path.exists(path) else None

    def reader(self, metric: str) -> ModuleType:
        return _module(os.path.join(self.dir, "metrics", f"{metric}.py"),
                       f"gpu_bench_metric_{metric.replace('.', '_')}")

    def end_to_end(self, workload: str) -> List[Mapping]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Mapping]:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run (weights, images, order ...),
    from the run's ``--seed`` and the stream's numbers."""
    state = np.random.SeedSequence([int(seed), *stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *stream))


# stream numbers of sub_seed
WEIGHTS, IMAGES, QUESTIONS, CALLS, SAMPLES, ORDER, COLLATE, DROPOUT, \
    CHECK = range(9)


def make_weights(spec: Sequence[Tuple[str, Tuple[int, ...], str, float,
                                      float]],
                 seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Every tensor of ``spec`` drawn from one normal buffer made on
    ``device`` by a generator seeded from ``seed``, in one call."""
    import torch

    total = sum(int(np.prod(shape)) for _, shape, kind, _, _ in spec
                if kind != "count")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, mean, std in spec:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = int(np.prod(shape))
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "normal":
            out[name] = x * std + mean
        elif kind == "lognormal":
            out[name] = torch.exp(x * std) * mean
        else:
            raise ValueError(f"unknown weight kind {kind!r} for {name}")
    return out


def answer_space(n: int) -> List[str]:
    return [f"answer{i:03d}" for i in range(n)]


def device_info(device, peak_bytes: int) -> Dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    what kept it from reading them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"


def forbidden_modules(modules: Mapping[str, object] = None) -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each module's name compared whole up to its first dot."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules}
                  & set(FORBIDDEN))
