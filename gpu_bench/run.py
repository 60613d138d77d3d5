"""Run one cell of the benchmark once.

    python3 -m gpu_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the run's log on standard error, each
number compared for ``correct`` beside its limit as the last lines there,
and one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last). With ``--trace 0`` the metrics are
the cell's end-to-end ones, with ``--trace 1`` its per-layer ones. Exits
with a code other than 0, and prints no result, without a CUDA device (or
with fewer than the cell asks for), when the program is missing, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Mapping, Optional  # noqa: E402

from gpu_bench import harness  # noqa: E402

# a library of the program that would load JAX by itself is kept from it
for _var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ.setdefault(_var, "0")
# every build and kernel cache at a fixed path inside the checkout
_CACHE = os.path.join(harness.OUT_DIR, "cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(_CACHE, "torch_extensions"))


class Ctx:
    """One run of one cell: what its loop and the metric readers see."""

    def __init__(self, bench: harness.Bench, workload: str, seed: int,
                 seconds: float, trace: bool, device, t0: float = T0,
                 cfg: Optional[Mapping] = None, mix: Optional[Mapping] = None,
                 fault: Optional[str] = None, control: bool = False,
                 limits: Optional[Mapping] = None, rounding: bool = False):
        from gpu_bench.trace import Tracer

        self.bench = bench
        self.workload = bench.workload(workload)
        self.name = workload
        self.cfg = cfg or bench.config(self.workload["config"])
        self.mix = mix or bench.mix(self.workload["traffic"])
        self.model = bench.model(self.workload["config"])
        self.loop = bench.loop(self.mix["kind"])
        self.part = bench.part(self.workload["config"], self.loop.MODE)
        self.limits = limits if limits is not None else bench.limits(workload)
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device, self.t0 = device, t0
        self.fault, self.control, self.rounding = fault, control, rounding
        self.tracer = Tracer(trace)
        self.readings: Dict[str, Dict[str, float]] = {}

    def log(self, line: str) -> None:
        print(f"[{time.perf_counter() - self.t0:8.2f}s] {line}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def settle(self) -> None:
        """The end of set-up: the device drained, Python's collector run and
        every object that set-up made moved out of its reach
        (``gc.freeze``), as a long-running server does, so that no
        collection over the model's objects falls in the window."""
        self.sync()
        gc.collect()
        gc.freeze()

    def thaw(self) -> None:
        """After the measured stretches: set-up's objects collectable
        again, so that the program is freed before the check."""
        gc.unfreeze()

    def profile(self, stretch):
        from gpu_bench import trace

        path = os.path.join(harness.OUT_DIR, "traces",
                            f"{self.name}.trace.json")
        return trace.profile(self.tracer, stretch, path)

    def judge(self, numbers: Mapping[str, float]) -> Dict[str, Dict]:
        """Each number that the cell's limits name, beside its limit; the
        other readings go to the log. No limits: nothing can pass."""
        self.readings["program"] = dict(numbers)
        if not self.limits:
            return {k: {"value": v, "limit": None}
                    for k, v in numbers.items()}
        for k, v in numbers.items():
            if k not in self.limits:
                self.log(f"reading {k} = {v} (not compared)")
        return {k: {"value": numbers[k], "limit": limit}
                for k, limit in self.limits.items()}


def run_cell(ctx: Ctx) -> Dict:
    ctx.log(f"{ctx.name}: config {ctx.cfg['name']}, traffic "
            f"{ctx.workload['traffic']}, seed {ctx.seed}, {ctx.seconds} s, "
            f"trace {int(ctx.trace)}, device {ctx.device}")
    outcome = ctx.loop.run(ctx)
    checks = outcome["checks"]
    outcome["correct"] = bool(
        outcome["failed"] == 0 and checks
        and all(c["limit"] is not None and c["value"] <= c["limit"]
                for c in checks.values()))
    return outcome


def per_layer(ctx: Ctx, outcome: Mapping) -> Dict[str, Dict]:
    out = {}
    for m in ctx.bench.per_layer(ctx.name):
        value = ctx.bench.reader(m["name"]).read(ctx, outcome)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(ctx: Ctx, outcome: Mapping) -> Dict:
    if ctx.trace:
        metrics = per_layer(ctx, outcome)
    else:
        metrics = {}
        for m in ctx.bench.end_to_end(ctx.name):
            if m["name"] not in outcome["metrics"]:
                raise KeyError(f"the {ctx.mix['kind']} loop gives no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": outcome["metrics"][m["name"]],
                                  "unit": m["unit"]}
    device = harness.device_info(ctx.device, outcome["peak_bytes"])
    line = {"correct": outcome["correct"], "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics,
            "device": device}
    profile = outcome.get("profile")
    if profile is not None:
        device["busy_s"] = profile.busy_s
        device["window_s"] = profile.window_s
        line["breakdown"] = profile.breakdown()
    line["checks"] = outcome["checks"]
    return line


def host_settings() -> None:
    """The process as a deployment on one card runs it: one CPU thread
    for PyTorch's own operators (as ``torchrun`` sets each worker), so
    that no pool of spinning threads shares the host with the Python
    thread that launches the work."""
    import torch

    torch.set_num_threads(1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    host_settings()
    device = torch.device("cuda", 0)
    ctx = Ctx(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), device)
    ctx.log(f"card: {harness.card_line()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    outcome = run_cell(ctx)
    line = result_line(ctx, outcome)
    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for key, metric in line["metrics"].items():
        ctx.log(f"{key} = {metric['value']} {metric['unit']}")
    for key, c in line["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
