"""Small sizes of the benchmark's configurations and mixes, for the CPU
tests: the same code paths, plain versions in place of the kernels."""

from __future__ import annotations

import copy

import torch

from gpu_bench import harness
from gpu_bench.run import Ctx

# float32 on both sides: sums in another order; Adam moves a weight whose
# gradient is near 0 by its LR either way
TINY_LIMITS = {"serve_closed": {"top1_gap": 1e-4, "prob_err": 1e-4},
               "train_steps": {"grad_err": 1e-4, "change_gap": 5e-2}}


def config(bench: harness.Bench, name: str) -> dict:
    cfg = copy.deepcopy(bench.config(name))
    cfg["compute_dtype"] = "float32"
    if "t5" in cfg:
        cfg["image_size"] = 64
        cfg["t5"].update(d_ff=128, num_layers=2)
        cfg["sga"]["blocks"] = 2
    else:
        cfg["image_size"] = 32
        cfg["vit"].update(hidden_size=32, num_layers=2, num_heads=2,
                          mlp_dim=64, patch_size=8, image_size=32)
        cfg["roberta"].update(hidden_size=32, num_layers=2, num_heads=2,
                              intermediate_size=64)
        cfg["train_config"]["model_kwargs"]["compute_dtype"] = "float32"
    return cfg


def mix(bench: harness.Bench, name: str) -> dict:
    m = copy.deepcopy(bench.mix(name))
    if m["kind"] == "serve_closed":
        m.update(session_batch=4, requests_per_call=8, image_pool=16,
                 warmup_calls=1, check_requests=8, check_block=4,
                 trace_calls=1)
    else:
        m.update(batch=4, samples=64, distinct_images=16, checked_steps=3,
                 warmup_steps=1, loss_read_every=2, num_training_steps=10,
                 trace_steps=2, reference_rows=2)
    return m


def ctx(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
        fault=None, control=False, bench=None) -> Ctx:
    bench = bench or harness.Bench()
    w = bench.workload(workload)
    m = mix(bench, w["traffic"])
    return Ctx(bench, workload, seed, seconds, False, torch.device("cpu"),
               cfg=config(bench, w["config"]), mix=m, fault=fault,
               control=control, limits=TINY_LIMITS[m["kind"]])
