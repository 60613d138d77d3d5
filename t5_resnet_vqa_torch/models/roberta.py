"""RoBERTa embeddings and encoder layers (HF ``RobertaModel`` pieces).

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/roberta.py``, with HF
``RobertaModel``'s ``state_dict`` keys (``word_embeddings``,
``position_embeddings``, ``token_type_embeddings``, ``LayerNorm``;
``attention.self.query/key/value``, ``attention.output.dense``,
``attention.output.LayerNorm``, ``intermediate.dense``, ``output.dense``,
``output.LayerNorm``). The cross-attention model drives these two pieces
directly over an [image; text] sequence with no attention mask:

  * ``RobertaEmbeddings``: word + learned position + token type 0 ->
    LayerNorm -> dropout. Position ids count up from ``pad_token_id + 1``
    over the tokens that are not ``pad_token_id``; those stay at
    ``pad_token_id``. As in the JAX package, the ids are the question
    tokenizer's: its pad is 0 and its EOS is 1, which is RoBERTa's pad, so
    EOS positions are pinned at 1 in both packages.
  * ``RobertaLayer``: post-LN block. Self-attention scaled by
    1/sqrt(head_dim) with fp32 scores, the probabilities cast to the
    compute dtype and P.V accumulated in fp32, which is the attention
    kernel's function: with ``use_kernel`` the core goes through
    ``ops/layers.py::dot_product_attention`` (no mask, no attention
    dropout: the JAX layer has none), the kernel for CUDA tensors and its
    plain version for CPU ones. Then dense + dropout -> LayerNorm(x + h),
    erf-GELU intermediate -> dense + dropout -> LayerNorm(x + h).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import dot_product_attention


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    dropout_rate: float = 0.1
    pad_token_id: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def roberta_base(cls) -> "RobertaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "RobertaConfig":
        return cls(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, max_position_embeddings=40)


class RobertaEmbeddings(nn.Module):
    def __init__(self, config: RobertaConfig = RobertaConfig.roberta_base()):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, L] ids -> [B, L, hidden]."""
        pad = self.config.pad_token_id
        mask = (input_ids != pad).long()
        position_ids = torch.cumsum(mask, dim=1) * mask + pad
        x = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids))
             + self.position_embeddings(position_ids))
        return self.dropout(self.LayerNorm(x))


class _SelfAttention(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class _Output(nn.Module):
    """dense -> dropout -> LayerNorm(x + h) (HF's ``RobertaSelfOutput`` and
    ``RobertaOutput``)."""

    def __init__(self, config: RobertaConfig, in_features: int):
        super().__init__()
        self.dense = nn.Linear(in_features, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(x + self.dropout(self.dense(h)))


class _Attention(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.self = _SelfAttention(config)
        self.output = _Output(config, config.hidden_size)


class _Intermediate(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class RobertaLayer(nn.Module):
    def __init__(self, config: RobertaConfig = RobertaConfig.roberta_base(),
                 use_kernel: bool = False):
        super().__init__()
        self.config = config
        self.use_kernel = use_kernel
        self.attention = _Attention(config)
        self.intermediate = _Intermediate(config)
        self.output = _Output(config, config.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, hidden] -> [B, S, hidden], every position attending to
        every other."""
        cfg = self.config
        B, S, _ = x.shape
        att = self.attention.self

        def heads(linear):
            return linear(x).reshape(B, S, -1,
                                     cfg.head_dim).transpose(1, 2)

        ctx = dot_product_attention(heads(att.query), heads(att.key),
                                    heads(att.value),
                                    use_kernel=self.use_kernel)
        ctx = ctx.transpose(1, 2).reshape(B, S, -1)
        x = self.attention.output(ctx, x)
        h = F.gelu(self.intermediate.dense(x))
        return self.output(h, x)
