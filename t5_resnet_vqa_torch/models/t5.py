"""T5 encoder and decoder stacks.

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/t5.py``, with HF
``state_dict`` keys (``embed_tokens``, ``block.{i}.layer.0.SelfAttention.q``,
``block.{i}.layer.1.DenseReluDense.wi`` in the encoder,
``block.{i}.layer.1.EncDecAttention.q`` and ``layer.2.DenseReluDense`` in
the decoder, ``final_layer_norm``):

  * RMSNorm (no mean subtraction, no bias), eps 1e-6, fp32 accumulation.
  * Attention WITHOUT 1/sqrt(d) scaling; scores and softmax in fp32.
  * Relative position bias (32 buckets, max distance 128; unidirectional in
    the decoder), owned by block 0 of a stack; block 0's bias already holds
    the mask bias (padding; causal AND padding in the decoder) and every
    later block reuses it. Cross-attention has no relative bias.
  * Pre-norm residual blocks, ReLU feed-forward, bias-free linears.
  * ``T5ForConditionalGeneration``: encoder and decoder over ONE token
    table (``shared``, ``encoder.embed_tokens``, ``decoder.embed_tokens``
    and ``lm_head`` are one ``nn.Parameter``), as the reference's
    ``T5ForConditionalGeneration`` ties them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def t5_base(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        """Small geometry for fast unit tests."""
        return cls(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_decoder_layers=2, num_heads=4)


class RMSNorm(nn.Module):
    """T5LayerNorm: x * rsqrt(mean(x^2) + eps) * weight, fp32 accumulation."""

    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return y.to(self.weight.dtype) * self.weight


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5Attention._relative_position_bucket semantics (float32 log,
    then truncation to int)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32).long()
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def attention_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 mask -> additive [B, 1, 1, S] fp32 bias."""
    return ((1.0 - attention_mask.float()) * _NEG_INF)[:, None, None, :]


def causal_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 mask -> additive causal [B, 1, S, S] fp32 bias (HF decoder
    semantics: the causal triangle AND the padding mask)."""
    S = attention_mask.shape[1]
    causal = torch.ones((S, S), dtype=torch.bool,
                        device=attention_mask.device).tril()
    keep = causal[None] & (attention_mask[:, None, :] > 0)
    zero = torch.zeros((), device=attention_mask.device)
    return torch.where(keep, zero, _NEG_INF)[:, None]


class T5Attention(nn.Module):
    def __init__(self, config: T5Config,
                 has_relative_attention_bias: bool = False,
                 bidirectional: bool = True):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        inner = config.num_heads * config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False)
        self.k = nn.Linear(config.d_model, inner, bias=False)
        self.v = nn.Linear(config.d_model, inner, bias=False)
        self.o = nn.Linear(inner, config.d_model, bias=False)
        self.dropout = nn.Dropout(config.dropout_rate)
        self.relative_attention_bias = (
            nn.Embedding(config.relative_attention_num_buckets,
                         config.num_heads)
            if has_relative_attention_bias else None)
        # a mesh's model axis (parallel.shard_model_): this rank's heads
        self.tp = None

    def compute_bias(self, q_len: int, k_len: int) -> torch.Tensor:
        """[1, heads, q_len, k_len] fp32 relative position bias; under tensor
        parallelism this rank's heads, read from the replicated table."""
        device = self.relative_attention_bias.weight.device
        ctx = torch.arange(q_len, device=device)[:, None]
        mem = torch.arange(k_len, device=device)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional,
            self.config.relative_attention_num_buckets,
            self.config.relative_attention_max_distance)
        table = self.relative_attention_bias.weight
        if self.tp is not None:
            from ..parallel.tensor_parallel import slice_replicated
            table = slice_replicated(table, 1, self.tp)
        values = F.embedding(buckets, table).float()             # [q, k, h]
        return values.permute(2, 0, 1)[None]

    def forward(self, hidden_states: torch.Tensor,
                position_bias: Optional[torch.Tensor] = None,
                mask_bias: Optional[torch.Tensor] = None,
                key_value_states: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (output, position_bias). With ``key_value_states`` the
        keys and values come from it (cross-attention), and the bias is
        [1, H, Sq, Sk]."""
        cfg = self.config
        B, Sq = hidden_states.shape[:2]
        kv = hidden_states if key_value_states is None else key_value_states
        Sk = kv.shape[1]

        def heads(proj, x):
            return proj(x).reshape(B, x.shape[1], -1,
                                   cfg.d_kv).transpose(1, 2)

        qh = heads(self.q, hidden_states)
        kh, vh = heads(self.k, kv), heads(self.v, kv)
        # fp32 scores and P.V, also under a bf16 autocast
        with torch.autocast(qh.device.type, enabled=False):
            scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
            if position_bias is None:
                if self.relative_attention_bias is not None:
                    position_bias = self.compute_bias(Sq, Sk)
                else:
                    position_bias = torch.zeros((1, qh.shape[1], Sq, Sk),
                                                device=scores.device)
                if mask_bias is not None:
                    position_bias = position_bias + mask_bias
            att = torch.softmax(scores + position_bias, dim=-1).to(qh.dtype)
            att = self.dropout(att)
            out = torch.matmul(att.float(), vh.float()).to(qh.dtype)
        out = out.transpose(1, 2).reshape(B, Sq, -1)
        return self.o(out), position_bias


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config: T5Config, has_relative_attention_bias: bool,
                 bidirectional: bool = True):
        super().__init__()
        self.SelfAttention = T5Attention(config, has_relative_attention_bias,
                                         bidirectional)
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, x, position_bias=None, mask_bias=None):
        att, position_bias = self.SelfAttention(
            self.layer_norm(x), position_bias, mask_bias)
        return x + self.dropout(att), position_bias


class T5LayerCrossAttention(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.EncDecAttention = T5Attention(config)
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, x, memory, position_bias=None, mask_bias=None):
        att, position_bias = self.EncDecAttention(
            self.layer_norm(x), position_bias, mask_bias,
            key_value_states=memory)
        return x + self.dropout(att), position_bias


class T5DenseReluDense(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.wi = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.wo = nn.Linear(config.d_ff, config.d_model, bias=False)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.dropout(torch.relu(self.wi(x))))


class T5LayerFF(nn.Module):
    def __init__(self, config: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(config)
        self.layer_norm = RMSNorm(config.d_model, config.layer_norm_epsilon)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dropout(self.DenseReluDense(self.layer_norm(x)))


class T5Block(nn.Module):
    """Encoder block: self-attention, then feed-forward."""

    def __init__(self, config: T5Config,
                 has_relative_attention_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(config, has_relative_attention_bias),
            T5LayerFF(config)])

    def forward(self, x, position_bias=None, mask_bias=None):
        x, position_bias = self.layer[0](x, position_bias, mask_bias)
        return self.layer[1](x), position_bias


class T5DecoderBlock(nn.Module):
    """Decoder block: causal self-attention, cross-attention over the
    encoder memory, then feed-forward."""

    def __init__(self, config: T5Config,
                 has_relative_attention_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(config, has_relative_attention_bias,
                                 bidirectional=False),
            T5LayerCrossAttention(config),
            T5LayerFF(config)])

    def forward(self, x, memory, position_bias=None, mask_bias=None,
                encdec_bias=None, memory_mask_bias=None):
        x, position_bias = self.layer[0](x, position_bias, mask_bias)
        x, encdec_bias = self.layer[1](x, memory, encdec_bias,
                                       memory_mask_bias)
        return self.layer[2](x), position_bias, encdec_bias


class T5Encoder(nn.Module):
    """Encoder stack (HF T5EncoderModel layout). It owns its token table,
    unless ``embed_tokens`` hands it one to share."""

    def __init__(self, config: T5Config,
                 embed_tokens: Optional[nn.Embedding] = None):
        super().__init__()
        self.config = config
        self.embed_tokens = (embed_tokens if embed_tokens is not None else
                             nn.Embedding(config.vocab_size, config.d_model))
        self.block = nn.ModuleList([
            T5Block(config, has_relative_attention_bias=(i == 0))
            for i in range(config.num_layers)])
        self.final_layer_norm = RMSNorm(config.d_model,
                                        config.layer_norm_epsilon)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.dropout(self.embed_tokens(input_ids.long()))
        mask_bias = (attention_mask_bias(attention_mask)
                     if attention_mask is not None else None)
        position_bias = None
        for block in self.block:
            x, position_bias = block(x, position_bias, mask_bias)
        return self.dropout(self.final_layer_norm(x))


class T5Decoder(nn.Module):
    """Decoder stack over an encoder memory (HF T5Stack decoder layout). It
    owns its token table, unless ``embed_tokens`` hands it one to share."""

    def __init__(self, config: T5Config,
                 embed_tokens: Optional[nn.Embedding] = None):
        super().__init__()
        self.config = config
        self.embed_tokens = (embed_tokens if embed_tokens is not None else
                             nn.Embedding(config.vocab_size, config.d_model))
        self.block = nn.ModuleList([
            T5DecoderBlock(config, has_relative_attention_bias=(i == 0))
            for i in range(config.num_decoder_layers)])
        self.final_layer_norm = RMSNorm(config.d_model,
                                        config.layer_norm_epsilon)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, input_ids: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.dropout(self.embed_tokens(input_ids.long()))
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask_bias = causal_mask_bias(attention_mask)
        memory_mask_bias = (attention_mask_bias(encoder_attention_mask)
                            if encoder_attention_mask is not None else None)
        position_bias = encdec_bias = None
        for block in self.block:
            x, position_bias, encdec_bias = block(
                x, encoder_hidden_states, position_bias, mask_bias,
                encdec_bias, memory_mask_bias)
        return self.dropout(self.final_layer_norm(x))


class T5ForConditionalGeneration(nn.Module):
    """Encoder, decoder and LM head over one tied token table, in HF
    ``T5ForConditionalGeneration`` keys. ``shared.weight``,
    ``encoder.embed_tokens.weight``, ``decoder.embed_tokens.weight`` and
    ``lm_head.weight`` are one parameter, so a strict load of the four tied
    keys fills one table."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Encoder(config, embed_tokens=self.shared)
        self.decoder = T5Decoder(config, embed_tokens=self.shared)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size,
                                 bias=False)
        self.lm_head.weight = self.shared.weight
