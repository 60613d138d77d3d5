"""Cross-attention ViT x RoBERTa VQA model.

PyTorch counterpart of
``t5_resnet_vqa_tpu/models/cross_attention_vqa.py``, with the reference's
``state_dict`` keys (``vit_embeddings``, ``roberta_embeddings``,
``roberta_encoder_layers.{i}``, ``vit_encoder_layers.{i}``, one shared
``layer_norm``, ``attention_pooler``, ``classification_layer``):

  image_emb = ViT embeddings(pixel values)       [B, 197, 768]  (frozen)
  text_emb  = RoBERTa embeddings(question ids)   [B, L, 768]
  concat    = [image_emb ; text_emb]
  for i in range(12):
      roberta_hidden = roberta_layer_i(concat)            (no mask)
      image_hidden   = vit_layer_i(image_hidden)          (frozen)
      concat = LayerNorm([roberta_hidden[:, 197:] ; image_hidden]
                         + [image_emb ; text_emb])
  AttentionPooler -> classifier -> log_softmax -> NLL

The stream order flips after the first layer, and every layer's residual
adds the *original* [image; text] embeddings onto the flipped [text; image]
sequence: a quirk of the reference that its trained checkpoints depend on,
kept as the JAX package keeps it. The frozen ViT embedding and layers run
under ``torch.no_grad()`` (the JAX model's ``stop_gradient``), unless
``fine_tune_vision``. With ``use_kernels`` (the default) the RoBERTa
self-attention (S = 197 + L, unmasked, no attention dropout) and the ViT
self-attention (S = 197) run on the attention kernel. Images arrive as
uint8 and are normalised with the ViT mean and std on the device. The
family has no separable vision tower, so it has no
``compute_vision_features`` and the trainer's feature cache stays off.

Training: ``python -m t5_resnet_vqa_torch.train.vit --set
model_kwargs.language_model_name=roberta-base``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import constants
from ..core.device import DeviceLike, resolve_device
from ..ops import AttentionPooler, log_softmax_nll
from ..utils.profiling import span
from .image_input import finalize_image_input
from .resnet_vqa import init_weights
from .roberta import RobertaConfig, RobertaEmbeddings, RobertaLayer
from .vit import ViTConfig, ViTEmbeddings, ViTLayer

_VIT_NORMALIZE = (constants.VIT_IMAGE_MEAN, constants.VIT_IMAGE_STD)


class CrossAttentionVitVQAModel(nn.Module):
    """Cross-attention-family VQA model.

    Built on ``device`` (default ``"cuda"``, which raises without a card;
    the CPU only when named) in ``dtype``, with weights drawn from
    ``generator`` (default: seeded with 0).
    """

    def __init__(self, answer_spaces: int,
                 temperature_scaler: float = 1.0,
                 vit_config: ViTConfig = ViTConfig.vit_base(),
                 roberta_config: RobertaConfig = RobertaConfig.roberta_base(),
                 fine_tune_vision: bool = False,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.temperature_scaler = temperature_scaler
        self.fine_tune_vision = fine_tune_vision
        self.num_layers = min(vit_config.num_layers, roberta_config.num_layers)
        self.num_image_tokens = vit_config.num_patches + 1
        hidden = vit_config.hidden_size
        self.roberta_embeddings = RobertaEmbeddings(roberta_config)
        self.vit_embeddings = ViTEmbeddings(vit_config)
        self.layer_norm = nn.LayerNorm(hidden, eps=1e-5)
        self.attention_pooler = AttentionPooler(hidden)
        self.classification_layer = nn.Linear(hidden, answer_spaces)
        self.roberta_encoder_layers = nn.ModuleList(
            [RobertaLayer(roberta_config, use_kernels)
             for _ in range(self.num_layers)])
        self.vit_encoder_layers = nn.ModuleList(
            [ViTLayer(vit_config, use_kernels)
             for _ in range(self.num_layers)])

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        with torch.no_grad():
            emb = self.vit_embeddings
            emb.cls_token.normal_(0.0, 0.02, generator=generator)
            emb.position_embeddings.normal_(0.0, 0.02, generator=generator)
        self.to(device=device, dtype=dtype)

    def frozen_modules(self):
        """JAX top-level modules with no gradient path: the ViT embedding
        and every interleaved ViT layer (``vit_layer_{i}``)."""
        if self.fine_tune_vision:
            return ()
        return ("vit_embeddings",) + tuple(
            f"vit_layer_{i}" for i in range(self.num_layers))

    def _vision_grad(self):
        return torch.set_grad_enabled(self.fine_tune_vision
                                      and torch.is_grad_enabled())

    def forward(
        self,
        question_input_ids: torch.Tensor,                 # [B, L]
        pixel_values: torch.Tensor,                       # [B, 224, 224, 3]
        annotation_ids: Optional[torch.Tensor] = None,    # [B]
        question_attention_masks: Optional[torch.Tensor] = None,  # unused
        decoder_question_input_ids: Optional[torch.Tensor] = None,
        decoder_question_attention_masks: Optional[torch.Tensor] = None,
        answer_input_ids: Optional[torch.Tensor] = None,
        answer_attention_masks: Optional[torch.Tensor] = None,
        image_tensors: Optional[torch.Tensor] = None,
        question_type_ids: Optional[torch.Tensor] = None,
    ):
        n_img = self.num_image_tokens
        with span("model.vision"):
            x = finalize_image_input(pixel_values, _VIT_NORMALIZE)
            with self._vision_grad():
                image_emb = self.vit_embeddings(x)
        with span("model.text"):
            text_emb = self.roberta_embeddings(question_input_ids)

        concat_embeddings = torch.cat([image_emb, text_emb], dim=1)
        concat_hidden = concat_embeddings
        image_hidden = image_emb
        for roberta, vit in zip(self.roberta_encoder_layers,
                                self.vit_encoder_layers):
            with span("model.text"):
                roberta_hidden = roberta(concat_hidden)
            with span("model.vision"), self._vision_grad():
                image_hidden = vit(image_hidden)[0]
            with span("model.fusion"):
                concat_hidden = torch.cat(
                    [roberta_hidden[:, n_img:], image_hidden], dim=1)
                concat_hidden = self.layer_norm(
                    concat_hidden + concat_embeddings)

        with span("model.head"):
            pooled = self.attention_pooler(concat_hidden)
            logits = self.classification_layer(pooled)
            return log_softmax_nll(logits, annotation_ids,
                                   temperature=self.temperature_scaler)
