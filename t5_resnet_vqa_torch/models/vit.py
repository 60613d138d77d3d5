"""ViT-base vision tower.

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/vit.py``, with HF
``ViTModel`` ``state_dict`` keys (``embeddings.patch_embeddings.projection``,
``encoder.layer.{i}.attention.attention.query``,
``encoder.layer.{i}.attention.output.dense``, ``layernorm_before``,
``intermediate.dense``, ``output.dense``, ``layernorm``, ``pooler.dense``):

  * patch embedding = 16x16/s16 conv over the NHWC pixel values (patches
    in row-major order), then the CLS token and the learned position
    embeddings (197 tokens at 224^2);
  * pre-norm blocks, LayerNorm eps 1e-12, erf-GELU MLP, softmax attention
    scaled by 1/sqrt(head_dim) with fp32 scores;
  * final LayerNorm; pooler = tanh(Linear) over the CLS token.

With ``use_kernel`` and no attention maps asked for, the attention core is
``ops/attention.py::fused_attention`` (through ``dot_product_attention``)
on the head views of the q, k and v projections (the counterpart of
``use_pallas and not need_attention``, vit.py:83): the kernel for CUDA
tensors, its plain version for CPU ones.
Its result is the [B, H, S, D] view of a contiguous [B, S, H, D] tensor, so
merging the heads is a free reshape. ``return_attentions=True`` takes the
plain path and also returns the stacked maps [num_layers, B, H, S, S].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import dot_product_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224
    layer_norm_eps: float = 1e-12

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def vit_base(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
                   patch_size=8, image_size=32)


class _Dense(nn.Module):
    """A linear under the key ``dense`` (HF's output/intermediate/pooler
    wrappers)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class ViTSelfAttention(nn.Module):
    def __init__(self, config: ViTConfig, use_kernel: bool = False):
        super().__init__()
        self.config = config
        self.use_kernel = use_kernel
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, need_attention: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """[B, S, hidden] -> (context [B, S, hidden], fp32 maps or None)."""
        cfg = self.config
        B, S, _ = x.shape

        def heads(linear):
            return linear(x).reshape(B, S, -1,
                                     cfg.head_dim).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        att = None
        if need_attention:          # attention_reference's math, with maps
            with torch.autocast(x.device.type, enabled=False):
                scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
                att = torch.softmax(scores / math.sqrt(cfg.head_dim), dim=-1)
                ctx = torch.matmul(att.to(q.dtype).float(),
                                   v.float()).to(q.dtype)
        else:
            ctx = dot_product_attention(q, k, v, use_kernel=self.use_kernel)
        return ctx.transpose(1, 2).reshape(B, S, -1), att


class ViTAttention(nn.Module):
    def __init__(self, config: ViTConfig, use_kernel: bool = False):
        super().__init__()
        self.attention = ViTSelfAttention(config, use_kernel)
        self.output = _Dense(config.hidden_size, config.hidden_size)

    def forward(self, x, need_attention: bool = False):
        ctx, att = self.attention(x, need_attention)
        return self.output(ctx), att


class ViTLayer(nn.Module):
    def __init__(self, config: ViTConfig, use_kernel: bool = False):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = ViTAttention(config, use_kernel)
        self.layernorm_before = nn.LayerNorm(h, eps=eps)
        self.layernorm_after = nn.LayerNorm(h, eps=eps)
        self.intermediate = _Dense(h, config.mlp_dim)
        self.output = _Dense(config.mlp_dim, h)

    def forward(self, x: torch.Tensor, need_attention: bool = False):
        att, att_map = self.attention(self.layernorm_before(x),
                                      need_attention)
        x = x + att
        h = F.gelu(self.intermediate(self.layernorm_after(x)))
        return x + self.output(h), att_map


class _PatchEmbeddings(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        p = config.patch_size
        self.projection = nn.Conv2d(3, config.hidden_size, p, stride=p)


class ViTEmbeddings(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        h = config.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, config.num_patches + 1, h))
        self.patch_embeddings = _PatchEmbeddings(config)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, 1 + patches, hidden]."""
        x = pixel_values.to(self.cls_token.dtype).permute(0, 3, 1, 2)
        patches = self.patch_embeddings.projection(x)    # [B, D, h, w]
        patches = patches.flatten(2).transpose(1, 2)     # row-major h, w
        cls = self.cls_token.expand(patches.shape[0], -1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embeddings


class _Encoder(nn.Module):
    def __init__(self, config: ViTConfig, use_kernel: bool):
        super().__init__()
        self.layer = nn.ModuleList([ViTLayer(config, use_kernel)
                                    for _ in range(config.num_layers)])


class ViTModel(nn.Module):
    """Returns (hidden states [B, S, hidden], pooled [B, hidden]), and the
    stacked attention maps with ``return_attentions``."""

    def __init__(self, config: ViTConfig = ViTConfig.vit_base(),
                 use_kernel: bool = False):
        super().__init__()
        self.config = config
        self.embeddings = ViTEmbeddings(config)
        self.encoder = _Encoder(config, use_kernel)
        self.layernorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)
        self.pooler = _Dense(config.hidden_size, config.hidden_size)

    def forward(self, pixel_values: torch.Tensor,
                return_attentions: bool = False):
        x = self.embeddings(pixel_values)
        maps = []
        for layer in self.encoder.layer:
            x, att = layer(x, need_attention=return_attentions)
            if return_attentions:
                maps.append(att)
        x = self.layernorm(x)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        if return_attentions:
            return x, pooled, torch.stack(maps, dim=0)
        return x, pooled
