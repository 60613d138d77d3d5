"""``cross_vitbase_robertabase`` on the program: the port's
``CrossAttentionVitVQAModel`` at the widths of ``config.json``, and the
shapes its counts share. What one mode needs besides (its counts and its
reference step) is in the mode's file beside this one (``serve.py``,
``train.py``). The plain reference is ``gpu_bench/reference/cross.py``."""

from __future__ import annotations

from typing import Dict, List, Mapping

from gpu_bench.reference import cross as reference

FAMILY = "cross_attention"


def build(cfg: Mapping, device, dropout: bool = False):
    """The port's model on ``device`` in float32, kernels on, RoBERTa's
    dropout at the configured rate when ``dropout``. Its own initial
    weights are replaced by the benchmark's."""
    import torch

    from t5_resnet_vqa_torch.models import (
        CrossAttentionVitVQAModel,
        RobertaConfig,
        ViTConfig,
    )

    r = dict(cfg["roberta"])
    if not dropout:
        r["dropout_rate"] = 0.0
    return CrossAttentionVitVQAModel(
        cfg["answers"], vit_config=ViTConfig(**cfg["vit"]),
        roberta_config=RobertaConfig(**r), use_kernels=True,
        dtype=torch.float32, device=device,
        generator=torch.Generator().manual_seed(0))


def sequences(cfg: Mapping):
    """(tokens of the ViT, tokens of the RoBERTa layers)."""
    v = cfg["vit"]
    image = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return image, image + cfg["question_len"]


def attention_calls(cfg: Mapping, stats: bool) -> List[Dict]:
    """Kernel 1's forward calls per sample: each interleaved layer's ViT
    self-attention (S=197) and RoBERTa self-attention (S=213), the latter
    writing the rows' statistics when ``stats`` (in training)."""
    v, r = cfg["vit"], cfg["roberta"]
    s_img, s_all = sequences(cfg)
    calls = []
    for _ in range(layers(cfg)):
        calls.append({"heads": r["num_heads"], "sq": s_all, "sk": s_all,
                      "d": r["hidden_size"] // r["num_heads"],
                      "stats": stats})
        calls.append({"heads": v["num_heads"], "sq": s_img, "sk": s_img,
                      "d": v["hidden_size"] // v["num_heads"],
                      "stats": False})
    return calls


def layers(cfg: Mapping) -> int:
    return min(cfg["vit"]["num_layers"], cfg["roberta"]["num_layers"])


def _layer_macs(S: int, h: int, ff: int) -> int:
    return S * (4 * h * h + 2 * h * ff) + 2 * S * S * h


def macs(cfg: Mapping):
    """Multiply-adds of one sample's forward: (the frozen ViT's, the
    trained RoBERTa layers', pooler's and classifier's)."""
    v, r = cfg["vit"], cfg["roberta"]
    s_img, s_all = sequences(cfg)
    h = v["hidden_size"]
    vit = (s_img - 1) * h * 3 * v["patch_size"] ** 2 \
        + layers(cfg) * _layer_macs(s_img, h, v["mlp_dim"])
    trained = layers(cfg) * _layer_macs(s_all, h, r["intermediate_size"]) \
        + s_all * h + h * cfg["answers"]
    return vit, trained
