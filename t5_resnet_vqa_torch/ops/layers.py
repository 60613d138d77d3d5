"""Fusion ops: multi-head attention, SGA blocks, pooling, channel projection.

PyTorch counterpart of ``t5_resnet_vqa_tpu/ops/layers.py``, with the
reference's ``state_dict`` keys (``mhatt1.linear_v``, ``norm1.norm``,
``ffn.mlp.fc1``, ``attention.0``). Dropout is the modules' own
(``nn.Dropout``), active only in ``train()`` mode.

The attention core routes to the hand-written kernel (``ops/attention.py``)
exactly where the JAX package routes to its Pallas kernel (layers.py:68):
the flag is on, there is no mask and no dropout. The wrapper then takes the
kernel for CUDA tensors and its plain version for CPU tensors. The kernel
reads the head views of the projections in place and returns a view whose
head merge in ``MultiHeadAttention.forward`` is a free reshape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..core import constants
from .attention import attention_reference, fused_attention


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """SGA geometry (the reference's TextConfiguration/ImageConfiguration)."""
    hidden_size: int = constants.HIDDEN_SIZE
    num_heads: int = constants.SGA_NUM_HEADS
    ff_size: int = constants.SGA_FF_SIZE
    dropout_rate: float = constants.SGA_DROPOUT

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          dropout_p: float = 0.0,
                          use_kernel: bool = False,
                          dropout: Optional[nn.Module] = None
                          ) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, Sq, D] / [B, H, Sk, D];
    ``mask`` marks masked positions with True. ``dropout``, where given,
    drops the probabilities in place of ``F.dropout`` (a mesh's heads)."""
    if use_kernel and mask is None and dropout_p == 0.0:
        return fused_attention(q, k, v)
    return attention_reference(q, k, v, mask, dropout_p, dropout)


class MultiHeadAttention(nn.Module):
    """MHAtt, called as (v, k, q). The head count is the projections' width
    over the head size: ``parallel.shard_model_`` leaves a rank its heads,
    and a sharded ``head_dropout``."""

    def __init__(self, config: AttentionConfig = AttentionConfig(),
                 use_kernel: bool = False):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.use_kernel = use_kernel
        self.linear_v = nn.Linear(h, h)
        self.linear_k = nn.Linear(h, h)
        self.linear_q = nn.Linear(h, h)
        self.linear_merge = nn.Linear(h, h)
        self.head_dropout: Optional[nn.Module] = None

    def forward(self, v: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        B, Sq = q.shape[0], q.shape[1]

        def heads(x, linear):
            return linear(x).reshape(B, x.shape[1], -1,
                                     cfg.head_dim).transpose(1, 2)

        dropout_p = cfg.dropout_rate if self.training else 0.0
        atted = dot_product_attention(
            heads(q, self.linear_q), heads(k, self.linear_k),
            heads(v, self.linear_v), mask, dropout_p=dropout_p,
            use_kernel=self.use_kernel, dropout=self.head_dropout)
        atted = atted.transpose(1, 2).reshape(B, Sq, -1)
        return self.linear_merge(atted)


class MLP(nn.Module):
    """fc1 -> ReLU -> dropout -> fc2."""

    def __init__(self, in_size: int, mid_size: int, out_size: int,
                 dropout_rate: float = constants.SGA_DROPOUT,
                 use_relu: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(in_size, mid_size)
        self.use_relu = use_relu
        self.dropout = nn.Dropout(dropout_rate)
        self.fc2 = nn.Linear(mid_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        if self.use_relu:
            x = torch.relu(x)
        return self.fc2(self.dropout(x))


class FFN(nn.Module):
    def __init__(self, config: AttentionConfig = AttentionConfig()):
        super().__init__()
        self.mlp = MLP(config.hidden_size, config.ff_size, config.hidden_size,
                       config.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class LayerNorm(nn.Module):
    """The reference's LayerNorm wrapper (key ``.norm``), eps 1e-5."""

    def __init__(self, size: int):
        super().__init__()
        self.norm = nn.LayerNorm(size, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class SGA(nn.Module):
    """Self-Guided Attention block. x: text stream [B, Sx, H]; y: guiding
    stream [B, Sy, H]."""

    def __init__(self, config: AttentionConfig = AttentionConfig(),
                 use_kernel: bool = False):
        super().__init__()
        h = config.hidden_size
        self.mhatt1 = MultiHeadAttention(config, use_kernel)
        self.mhatt2 = MultiHeadAttention(config, use_kernel)
        self.ffn = FFN(config)
        self.dropout1 = nn.Dropout(config.dropout_rate)
        self.dropout2 = nn.Dropout(config.dropout_rate)
        self.dropout3 = nn.Dropout(config.dropout_rate)
        self.norm1 = LayerNorm(h)
        self.norm2 = LayerNorm(h)
        self.norm3 = LayerNorm(h)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                y_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.dropout1(self.mhatt1(x, x, x, x_mask)))
        x = self.norm2(x + self.dropout2(self.mhatt2(y, y, x, y_mask)))
        return self.norm3(x + self.dropout3(self.ffn(x)))


class SGAStack(nn.ModuleList):
    """The models' SGA loop: every block reads the *fresh* text states as x
    and the previous output as y; the first y is the vision tokens."""

    def __init__(self, num_blocks: int = constants.SGA_DEFAULT_BLOCKS,
                 config: AttentionConfig = AttentionConfig(),
                 use_kernel: bool = False):
        super().__init__([SGA(config, use_kernel) for _ in range(num_blocks)])

    def forward(self, text_states: torch.Tensor,
                vision_states: torch.Tensor) -> torch.Tensor:
        y = vision_states
        for block in self:
            y = block(text_states, y)
        return y


class AttentionPooler(nn.Module):
    """Linear(h -> 1), softmax over the sequence, weighted sum."""

    def __init__(self, hidden_size: int = constants.HIDDEN_SIZE):
        super().__init__()
        self.attention = nn.Sequential(nn.Linear(hidden_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.attention(x), dim=1)                 # [B, S, 1]
        with torch.autocast(x.device.type, enabled=False):    # fp32 sum
            return torch.einsum("bsh,bso->bh", x.float(),
                                w.float()).to(x.dtype)


class ChannelProjection(nn.ConvTranspose2d):
    """The reference's ConvTranspose2d(k3, s1, p1) channel up/down-scaler.
    The JAX package stores it as the equivalent flipped SAME conv; the
    weight bridge (utils/weights.py) undoes the flip."""

    def __init__(self, in_channels: int,
                 out_channels: int = constants.HIDDEN_SIZE):
        super().__init__(in_channels, out_channels, 3, stride=1, padding=1)


def log_softmax_nll(logits: torch.Tensor, labels: Optional[torch.Tensor],
                    temperature: float = 1.0
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """log_softmax + mean NLL. Returns (log_probs, loss or None).

    Logits divide by ``temperature`` first. The log-probs are computed and
    returned in fp32 whatever the compute dtype, so that a bf16 model's
    probabilities still sum to one to fp32 rounding.
    """
    if temperature != 1.0:
        logits = logits / temperature
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    if labels is None:
        return log_probs, None
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    return log_probs, nll.mean()
