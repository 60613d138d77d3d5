"""Model factory: config -> model instance and collate family.

PyTorch counterpart of the JAX package's ``train/factory.py``: the CNN
family (resnet18/34/50 and faster-rcnn towers), the ViT + T5
encoder-decoder family, and the ViT x RoBERTa cross-attention family
(``language_model_name="roberta-base"`` with a ViT vision model).

The model is built in fp32 whatever ``compute_dtype`` says: the trainer
keeps fp32 master weights and computes in bf16 under autocast. The
hand-written kernels are on (``use_kernels``); ``use_pallas``, the JAX
package's switch for its Pallas attention, has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.device import DeviceLike
from ..models import (
    CrossAttentionVitVQAModel,
    FasterRcnnVQAModel,
    ResnetVQAModel,
    T5Config,
    VitVQAModel,
)
from ..ops import AttentionConfig

CNN_FAMILY = "cnn"
VIT_FAMILY = "vit"
CROSS_FAMILY = "cross_attention"


def model_family(model_cfg: ModelConfig) -> str:
    name = model_cfg.vision_model_name
    if name in ("resnet18", "resnet34", "resnet50", "faster-rcnn"):
        return CNN_FAMILY
    if model_cfg.language_model_name == "roberta-base":
        return CROSS_FAMILY
    return VIT_FAMILY


def build_model(model_cfg: ModelConfig, num_answers: int,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[nn.Module, str]:
    """Returns (model on ``device``, family string). Weights are drawn from
    ``generator`` (default: seeded with 0)."""
    family = model_family(model_cfg)
    name = model_cfg.vision_model_name
    common = dict(temperature_scaler=model_cfg.temperature_scaler,
                  fine_tune_vision=model_cfg.fine_tune_vision,
                  use_kernels=True, device=device, generator=generator)
    if family == VIT_FAMILY:
        model = VitVQAModel(num_answers, t5_config=T5Config.t5_base(),
                            **common)
    elif family == CROSS_FAMILY:
        model = CrossAttentionVitVQAModel(num_answers, **common)
    elif name == "faster-rcnn":
        model = FasterRcnnVQAModel(
            num_answers, t5_config=T5Config.t5_base(),
            num_attention_blocks=model_cfg.num_attention_blocks,
            sga_config=AttentionConfig(), fpn_channels=256, **common)
    else:
        model = ResnetVQAModel(
            num_answers, vision_model_name=name,
            t5_config=T5Config.t5_base(),
            num_attention_blocks=model_cfg.num_attention_blocks,
            sga_config=AttentionConfig(), **common)
    return model, family
