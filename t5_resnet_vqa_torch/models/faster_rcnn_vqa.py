"""Faster-RCNN (ResNet-50 + FPN) + T5-encoder + SGA VQA model.

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/faster_rcnn_vqa.py``,
with the reference's ``state_dict`` keys (``vision_model.body`` = a
``FrozenBatchNorm2d`` ResNet-50 without ``fc`` or batch trackers,
``vision_model.fpn``, ``upscale_layer``, ``lang_model``, ``sga_modules``,
``attention_pooler``, ``classification_layer``). The CNN family's skeleton
with another tower:

  frozen ResNet-50 body -> FPN 'pool' level [B, 256, 4, 4]   (under no_grad)
  ConvTranspose(k3, s1, p1) 256 -> hidden: 16 vision tokens
  T5 encoder over question ids [B, 16] -> text states
  SGA stack -> AttentionPooler -> classifier -> log_softmax -> NLL

With ``use_kernels`` (the default) the body's bottlenecks of stages 0 and 1
go through the fused bottleneck kernel and every SGA attention core through
the attention kernel (the JAX model runs its tower unfused; the kernel
computes the same frozen bottleneck, and the kernels on/off comparison on
the card holds the two routes together). A fine-tuned tower
(``fine_tune_vision``) runs through the modules with autograd. Only the
``pool`` level is computed unless ``return_features`` asks for all of them
(``models/fpn.py``).

Training: ``python -m t5_resnet_vqa_torch.train --set
model_kwargs.vision_model_name=faster-rcnn``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core import constants
from ..core.device import DeviceLike, resolve_device
from ..ops import (
    AttentionConfig,
    AttentionPooler,
    ChannelProjection,
    SGAStack,
    log_softmax_nll,
)
from .fpn import FPN
from .image_input import finalize_image_input
from .resnet import ResNetBackbone
from .resnet_vqa import init_weights
from .t5 import T5Config, T5Encoder

# ResNet-50's C2..C5 widths, the FPN's inputs
_BODY_CHANNELS = (256, 512, 1024, 2048)


class BackboneWithFPN(nn.Module):
    """torchvision's ``BackboneWithFPN``: ``body`` then ``fpn``."""

    def __init__(self, use_kernel: bool, fpn_channels: int):
        super().__init__()
        self.body = ResNetBackbone("resnet50", use_kernel, body_only=True)
        self.fpn = FPN(_BODY_CHANNELS, fpn_channels)

    def forward(self, x: torch.Tensor,
                all_levels: bool = False) -> Dict[str, torch.Tensor]:
        return self.fpn(self.body(x), all_levels)


class FasterRcnnVQAModel(nn.Module):
    """Faster-RCNN-family VQA model.

    Built on ``device`` (default ``"cuda"``, which raises without a card;
    the CPU only when named) in ``dtype``, with weights drawn from
    ``generator`` (default: seeded with 0).
    """

    def __init__(self, answer_spaces: int,
                 temperature_scaler: float = 1.0,
                 t5_config: T5Config = T5Config.t5_base(),
                 num_attention_blocks: int = constants.SGA_DEFAULT_BLOCKS,
                 sga_config: AttentionConfig = AttentionConfig(),
                 fpn_channels: int = 256,
                 fine_tune_vision: bool = False,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.temperature_scaler = temperature_scaler
        self.fine_tune_vision = fine_tune_vision
        hidden = sga_config.hidden_size
        self.vision_model = BackboneWithFPN(
            use_kernels and not fine_tune_vision, fpn_channels)
        self.upscale_layer = ChannelProjection(fpn_channels, hidden)
        self.lang_model = T5Encoder(t5_config)
        self.sga_modules = SGAStack(num_attention_blocks, sga_config,
                                    use_kernels)
        self.attention_pooler = AttentionPooler(hidden)
        self.classification_layer = nn.Linear(hidden, answer_spaces)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(device=device, dtype=dtype)

    def frozen_modules(self):
        """JAX top-level modules with no gradient path (the body is JAX's
        ``vision_model``, the FPN its ``fpn``)."""
        return () if self.fine_tune_vision else ("vision_model", "fpn")

    def _dtype(self) -> torch.dtype:
        return self.classification_layer.weight.dtype

    def _levels(self, image_tensors: torch.Tensor,
                all_levels: bool) -> Dict[str, torch.Tensor]:
        """Tower forward: uint8/float NHWC images -> FPN levels, NHWC, in
        the tower's dtype; without a gradient unless ``fine_tune_vision``."""
        x = finalize_image_input(image_tensors).to(
            self.vision_model.body.conv1.weight.dtype)
        with torch.set_grad_enabled(self.fine_tune_vision
                                    and torch.is_grad_enabled()):
            levels = self.vision_model(x.permute(0, 3, 1, 2), all_levels)
        return {k: v.permute(0, 2, 3, 1) for k, v in levels.items()}

    def compute_vision_features(self, image_tensors: torch.Tensor
                                ) -> torch.Tensor:
        """The ``pool`` level [B, 4, 4, fpn_channels] (NHWC) that the
        feature cache holds."""
        return self._levels(image_tensors, False)["pool"]

    def forward(
        self,
        question_input_ids: torch.Tensor,                 # [B, 16]
        question_attention_masks: torch.Tensor,           # [B, 16]
        image_tensors: Optional[torch.Tensor] = None,     # [B, H, W, 3] NHWC
        annotation_ids: Optional[torch.Tensor] = None,    # [B]
        decoder_question_input_ids: Optional[torch.Tensor] = None,  # unused
        decoder_question_attention_masks: Optional[torch.Tensor] = None,
        answer_input_ids: Optional[torch.Tensor] = None,
        answer_attention_masks: Optional[torch.Tensor] = None,
        pixel_values: Optional[torch.Tensor] = None,
        question_type_ids: Optional[torch.Tensor] = None,
        vision_features: Optional[torch.Tensor] = None,   # cached 'pool'
        return_features: bool = False,
    ):
        levels = None
        if vision_features is not None:
            if return_features:
                raise ValueError(
                    "return_features requires the in-graph tower")
            pool = vision_features.to(self._dtype())
        else:
            levels = self._levels(image_tensors, return_features)
            pool = levels["pool"]

        vision_embeddings = self.upscale_layer(
            pool.permute(0, 3, 1, 2))                     # [B, hidden, 4, 4]
        B, hidden = vision_embeddings.shape[:2]
        vision_tokens = vision_embeddings.permute(0, 2, 3, 1).reshape(
            B, -1, hidden)                                # [B, 16, hidden]

        text_states = self.lang_model(question_input_ids,
                                      question_attention_masks)
        fused = self.sga_modules(text_states, vision_tokens)
        pooled = self.attention_pooler(fused)
        logits = self.classification_layer(pooled)
        log_probs, loss = log_softmax_nll(logits, annotation_ids,
                                          temperature=self.temperature_scaler)
        if return_features:
            return log_probs, loss, levels
        return log_probs, loss
