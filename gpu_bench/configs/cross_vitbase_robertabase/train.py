"""``cross_vitbase_robertabase`` trained: the counts the metrics need for
one sample's training step and the reference's training steps."""

from __future__ import annotations

from typing import Dict, List, Mapping

from gpu_bench import harness

model = harness.beside(__file__, "model")
train_steps = model.reference.train_steps


def attention_calls(cfg: Mapping) -> List[Dict]:
    """Kernel 1's forward calls per sample; RoBERTa's write the rows'
    statistics that its backward reads."""
    return model.attention_calls(cfg, stats=True)


def attention_bwd_calls(cfg: Mapping) -> List[Dict]:
    """Kernel 1's backward calls per sample: RoBERTa's."""
    return [c for c in attention_calls(cfg) if c["stats"]]


def flops_per_sample(cfg: Mapping) -> float:
    """Model FLOPs (2 per multiply-add of every product) of one sample:
    the frozen ViT's forward plus the trained part's forward and backward
    (twice its forward), with nothing recomputed counted."""
    vit, trained = model.macs(cfg)
    return 2.0 * (vit + 3 * trained)
