"""ResNet + T5-encoder + SGA VQA model (CNN family).

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/resnet_vqa.py``, with the
reference's ``state_dict`` keys (``vision_model``, ``downscale_layer`` /
``upscale_layer``, ``lang_model``, ``sga_modules``, ``attention_pooler``,
``classification_layer``):

  frozen resnet18/34/50 -> C5 map                  (under no_grad)
  ConvTranspose(k3, s1, p1) channel projection -> hidden
  T5 encoder over question ids [B, 16] -> text states
  SGA stack: x = fresh text states, y = previous output (first: vision tokens)
  AttentionPooler -> classifier -> log_softmax -> NLL

With ``use_kernels`` (the default) the ResNet-50 bottlenecks of stages 0
and 1 and every SGA attention core go through the hand-written
kernels (``ops/bottleneck.py``, ``ops/attention.py``); on CPU tensors those
wrappers use their plain versions.

The tower is frozen unless ``fine_tune_vision``: it then runs under
``torch.no_grad()``, the counterpart of the JAX model's
``jax.lax.stop_gradient``. With ``fine_tune_vision`` every stage runs
through the modules with autograd, as in the JAX model: the bottleneck
kernel has no backward in either package, so it serves the frozen tower
only.
"""

from __future__ import annotations

from typing import Optional

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
from ..utils.profiling import span
from .image_input import finalize_image_input
from .resnet import (
    Bottleneck,
    FrozenBatchNorm,
    ResNetBackbone,
    resnet_out_channels,
)
from .t5 import T5Config, T5Encoder


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, in module order: linears N(0, 0.02),
    convolutions fan-in normal (biases 0), embeddings N(0, 1), and frozen
    BatchNorms with non-trivial statistics so that the BN fold is
    exercised. The bottlenecks' fused operands are folded again from the
    new weights."""
    g = generator
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5,
                                 generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=g)
            elif isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.0, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    for m in model.modules():
        if isinstance(m, Bottleneck):
            m.refresh_fused_operands()


class ResnetVQAModel(nn.Module):
    """CNN-family VQA model (resnet18/34/50 towers).

    Built on ``device`` (default ``"cuda"``, which raises without a card;
    the CPU only when named) in ``dtype``, with weights drawn from
    ``generator`` (default: seeded with 0).
    """

    def __init__(self, answer_spaces: int,
                 temperature_scaler: float = 1.0,
                 vision_model_name: str = "resnet50",
                 t5_config: T5Config = T5Config.t5_base(),
                 num_attention_blocks: int = constants.SGA_DEFAULT_BLOCKS,
                 sga_config: AttentionConfig = AttentionConfig(),
                 fine_tune_vision: bool = False,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.temperature_scaler = temperature_scaler
        self.vision_model_name = vision_model_name
        self.fine_tune_vision = fine_tune_vision
        hidden = sga_config.hidden_size

        self.vision_model = ResNetBackbone(
            vision_model_name, use_kernels and not fine_tune_vision)
        # the reference holds both projections and uses one; the unused twin
        # keeps its fixed 768-wide shape so strict loading succeeds
        feats = resnet_out_channels(vision_model_name)
        if vision_model_name == "resnet50":
            self.downscale_layer = ChannelProjection(feats, hidden)
            self.upscale_layer = ChannelProjection(512, constants.HIDDEN_SIZE)
        else:
            self.upscale_layer = ChannelProjection(feats, hidden)
            self.downscale_layer = ChannelProjection(2048,
                                                     constants.HIDDEN_SIZE)
        self.lang_model = T5Encoder(t5_config)
        self.sga_modules = SGAStack(num_attention_blocks, sga_config,
                                    use_kernels)
        self.attention_pooler = AttentionPooler(hidden)
        self.classification_layer = nn.Linear(hidden, answer_spaces)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(device=device, dtype=dtype)

    @property
    def projection(self) -> ChannelProjection:
        return (self.downscale_layer if self.vision_model_name == "resnet50"
                else self.upscale_layer)

    def frozen_modules(self):
        """Top-level modules with no gradient path."""
        return () if self.fine_tune_vision else ("vision_model",)

    def _dtype(self) -> torch.dtype:
        return self.classification_layer.weight.dtype

    def compute_vision_features(self, image_tensors: torch.Tensor
                                ) -> torch.Tensor:
        """Tower forward: uint8/float NHWC images -> C5 map, NHWC, in the
        tower's dtype; without a gradient unless ``fine_tune_vision``."""
        x = finalize_image_input(image_tensors).to(
            self.vision_model.conv1.weight.dtype)
        with torch.set_grad_enabled(self.fine_tune_vision
                                    and torch.is_grad_enabled()):
            c5 = self.vision_model(x.permute(0, 3, 1, 2))[-1]
        return c5.permute(0, 2, 3, 1)

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
        vision_features: Optional[torch.Tensor] = None,   # cached C5, NHWC
        return_features: bool = False,
    ):
        if vision_features is not None:
            image_features = vision_features.to(self._dtype())
        else:
            with span("model.vision"):
                image_features = self.compute_vision_features(image_tensors)

        with span("model.text"):
            text_states = self.lang_model(question_input_ids,
                                          question_attention_masks)
        with span("model.fusion"):
            vision_embeddings = self.projection(
                image_features.permute(0, 3, 1, 2))       # [B, hidden, h, w]
            B, hidden = vision_embeddings.shape[:2]
            # row-major h*w token order, whatever the memory layout
            vision_tokens = vision_embeddings.permute(0, 2, 3, 1).reshape(
                B, -1, hidden)
            fused = self.sga_modules(text_states, vision_tokens)
        with span("model.head"):
            pooled = self.attention_pooler(fused)
            logits = self.classification_layer(pooled)
            log_probs, loss = log_softmax_nll(
                logits, annotation_ids, temperature=self.temperature_scaler)
        if return_features:
            return log_probs, loss, {"features": image_features}
        return log_probs, loss
