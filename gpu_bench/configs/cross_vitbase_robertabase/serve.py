"""``cross_vitbase_robertabase`` served: the counts the metrics need for
one pair's forward and the reference's served log-probs."""

from __future__ import annotations

from typing import Dict, List, Mapping

from gpu_bench import harness

model = harness.beside(__file__, "model")
serve_logprobs = model.reference.serve_logprobs


def attention_calls(cfg: Mapping) -> List[Dict]:
    """Kernel 1's forward calls per pair (no row statistics)."""
    return model.attention_calls(cfg, stats=False)


def flops_per_sample(cfg: Mapping) -> float:
    """Model FLOPs (2 per multiply-add of every product) of one pair's
    forward."""
    return 2.0 * sum(model.macs(cfg))
