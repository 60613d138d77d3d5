"""ViT + T5 encoder-decoder VQA model (ViT family).

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/vit_vqa.py``, with the
reference's ``state_dict`` keys (``vision_model`` = HF ``ViTModel``,
``lang_model`` = HF ``T5ForConditionalGeneration`` with one tied table,
``fusing_layer.0``, ``classification_layer``):

  frozen ViT-base -> pooled CLS [B, 768]                 (under no_grad)
  T5 encoder over question ids -> token-0 state [B, 768]
  concat [B, 1536] -> fusing layer: Linear -> ReLU -> Dropout
  (``fusing_dropout``, 0.5 as in the reference)
  T5 decoder with the fused vector as a 1-token memory (no memory mask),
  decoder input "[Question] {q} [Answer]"
  hidden state at the LAST non-pad decoder position -> classifier ->
  log_softmax -> NLL

``fuse`` and ``decode_hidden`` / ``decode_vocab_logits`` are the two halves
the generation path (``models/generation.py``) drives. With ``use_kernels``
(the default) the ViT self-attention runs on the hand-written attention
kernel (``ops/attention.py``); on CPU tensors the wrapper uses its plain
version. The tower is frozen unless ``fine_tune_vision``: it then runs
under ``torch.no_grad()``, the counterpart of ``jax.lax.stop_gradient``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import constants
from ..core.device import DeviceLike, resolve_device
from ..ops import log_softmax_nll
from .image_input import finalize_image_input
from .resnet_vqa import init_weights
from .t5 import T5Config, T5ForConditionalGeneration
from .vit import ViTConfig, ViTModel

_VIT_NORMALIZE = (constants.VIT_IMAGE_MEAN, constants.VIT_IMAGE_STD)


def init_vit_vqa_weights(model: "VitVQAModel",
                         generator: torch.Generator) -> None:
    """Random weights from ``generator``: ``init_weights``' draws, then the
    ViT's CLS token and position embeddings N(0, 0.02) and its patch
    convolution's bias 0, then the tied token table N(0, d_model**-0.5),
    the scale of flax's default embedding init in the JAX package. (At
    ``init_weights``' N(0, 1) the embedding of a prompt's last token, EOS,
    outweighs the random layers' updates, and the tied head predicts it
    again: every generated answer would be EOS.)"""
    init_weights(model, generator)
    emb = model.vision_model.embeddings
    table = model.lang_model.shared.weight
    with torch.no_grad():
        emb.patch_embeddings.projection.bias.zero_()
        emb.cls_token.normal_(0.0, 0.02, generator=generator)
        emb.position_embeddings.normal_(0.0, 0.02, generator=generator)
        table.normal_(0.0, table.shape[1] ** -0.5, generator=generator)


class VitVQAModel(nn.Module):
    """ViT-family VQA model.

    Built on ``device`` (default ``"cuda"``, which raises without a card;
    the CPU only when named) in ``dtype``, with weights drawn from
    ``generator`` (default: seeded with 0).
    """

    def __init__(self, answer_spaces: int,
                 temperature_scaler: float = 1.0,
                 t5_config: T5Config = T5Config.t5_base(),
                 vit_config: ViTConfig = ViTConfig.vit_base(),
                 fine_tune_vision: bool = False,
                 use_kernels: bool = True,
                 fusing_dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.temperature_scaler = temperature_scaler
        self.fine_tune_vision = fine_tune_vision
        self.t5_config = t5_config
        d = t5_config.d_model
        self.vision_model = ViTModel(vit_config, use_kernel=use_kernels)
        self.lang_model = T5ForConditionalGeneration(t5_config)
        self.fusing_layer = nn.Sequential(
            nn.Linear(vit_config.hidden_size + d, d), nn.ReLU(),
            nn.Dropout(fusing_dropout))
        self.classification_layer = nn.Linear(d, answer_spaces)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_vit_vqa_weights(self, generator)
        self.to(device=device, dtype=dtype)

    def frozen_modules(self):
        """Top-level modules with no gradient path."""
        return () if self.fine_tune_vision else ("vision_model",)

    def vision_tower_deterministic(self) -> bool:
        """The feature cache's exactness condition: the tower applies no
        stochastic regularization. The port's ViT has no dropout (the in21k
        checkpoint's rate is 0), so its features in training and in the
        cache are the same."""
        return True

    def compute_vision_features(self, pixel_values: torch.Tensor
                                ) -> torch.Tensor:
        """Tower forward: uint8/float NHWC images -> pooled CLS [B, hidden];
        without a gradient unless ``fine_tune_vision``."""
        x = finalize_image_input(pixel_values, _VIT_NORMALIZE)
        with torch.set_grad_enabled(self.fine_tune_vision
                                    and torch.is_grad_enabled()):
            return self.vision_model(x)[1]

    # ------------------------------------------------------------- halves

    def fuse(self, question_input_ids: torch.Tensor,
             question_attention_masks: torch.Tensor,
             pixel_values: Optional[torch.Tensor] = None,
             return_attentions: bool = False,
             vision_features: Optional[torch.Tensor] = None):
        """Pooled CLS + T5-encoder token 0 -> fused [B, d_model]; with
        ``return_attentions`` also the ViT attention maps. ``vision_features``
        (a pooled CLS computed before) stands in for the tower."""
        att_maps = None
        if return_attentions:
            x = finalize_image_input(pixel_values, _VIT_NORMALIZE)
            with torch.set_grad_enabled(self.fine_tune_vision
                                        and torch.is_grad_enabled()):
                _, pooled, att_maps = self.vision_model(x, True)
        elif vision_features is not None:
            pooled = vision_features.to(self.classification_layer.weight.dtype)
        else:
            pooled = self.compute_vision_features(pixel_values)
        enc = self.lang_model.encoder(question_input_ids,
                                      question_attention_masks)
        fused = self.fusing_layer(torch.cat([pooled, enc[:, 0]], dim=-1))
        if return_attentions:
            return fused, att_maps
        return fused

    def decode_hidden(self, decoder_input_ids: torch.Tensor,
                      decoder_attention_mask: torch.Tensor,
                      fused: torch.Tensor) -> torch.Tensor:
        """T5 decoder over the 1-token fused memory."""
        return self.lang_model.decoder(decoder_input_ids, fused[:, None, :],
                                       decoder_attention_mask)

    def vocab_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The tied LM head on decoder states [..., d_model] -> fp32 logits
        [..., vocab]. The states are scaled by d_model**-0.5 in their dtype
        and multiplied by the table cast to that dtype, with the products
        summed in fp32 into an fp32 result (``preferred_element_type``):
        a bf16 matmul would round the logits to bf16 before the argmax."""
        hidden = hidden * (self.t5_config.d_model ** -0.5)
        table = self.lang_model.shared.weight.to(hidden.dtype)
        with torch.autocast(hidden.device.type, enabled=False):
            return torch.matmul(hidden.float(), table.float().t())

    def decode_vocab_logits(self, decoder_input_ids: torch.Tensor,
                            decoder_attention_mask: torch.Tensor,
                            fused: torch.Tensor) -> torch.Tensor:
        """fp32 vocab logits [B, S, vocab] at every decoder position."""
        return self.vocab_logits(self.decode_hidden(
            decoder_input_ids, decoder_attention_mask, fused))

    # -------------------------------------------------------------- forward

    def forward(
        self,
        question_input_ids: torch.Tensor,                  # [B, Sq]
        question_attention_masks: torch.Tensor,            # [B, Sq]
        decoder_question_input_ids: torch.Tensor,          # [B, 20]
        decoder_question_attention_masks: torch.Tensor,    # [B, 20]
        pixel_values: Optional[torch.Tensor] = None,       # [B, 224, 224, 3]
        annotation_ids: Optional[torch.Tensor] = None,     # [B]
        image_tensors: Optional[torch.Tensor] = None,      # unused
        answer_input_ids: Optional[torch.Tensor] = None,
        answer_attention_masks: Optional[torch.Tensor] = None,
        question_type_ids: Optional[torch.Tensor] = None,
        vision_features: Optional[torch.Tensor] = None,    # cached CLS
        return_attentions: bool = False,
    ):
        if return_attentions and vision_features is not None:
            raise ValueError("return_attentions requires the in-graph ViT "
                             "tower (got cached vision_features)")
        fused = self.fuse(question_input_ids, question_attention_masks,
                          pixel_values, return_attentions, vision_features)
        if return_attentions:
            fused, att_maps = fused
        dec = self.decode_hidden(decoder_question_input_ids,
                                 decoder_question_attention_masks, fused)

        # the last non-pad position of each row
        mask = decoder_question_attention_masks
        positions = torch.arange(mask.shape[1], device=mask.device)
        idx = torch.where(mask == 1, positions, 0).amax(dim=1)
        ans_embedding = dec[torch.arange(dec.shape[0], device=dec.device), idx]

        logits = self.classification_layer(ans_embedding)
        log_probs, loss = log_softmax_nll(logits, annotation_ids,
                                          temperature=self.temperature_scaler)
        if return_attentions:
            return log_probs, loss, att_maps
        return log_probs, loss
