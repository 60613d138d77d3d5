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
  * A grad-free encoder forward on a card replays a CUDA graph of itself
    (``T5Encoder``'s docstring): a few hundred small launches become one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import count

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


class _Graph(NamedTuple):
    """One captured encoder forward: its static inputs and output."""

    graph: "torch.cuda.CUDAGraph"
    ids: torch.Tensor
    mask: Optional[torch.Tensor]
    out: torch.Tensor


class T5Encoder(nn.Module):
    """Encoder stack (HF T5EncoderModel layout). It owns its token table,
    unless ``embed_tokens`` hands it one to share.

    A forward replays a CUDA graph of itself where the call allows it, and
    runs eagerly otherwise; both give the same result. It replays when the
    ids are on a CUDA device, no gradient is recorded (``inference_mode``
    or ``no_grad``), every module of the stack is in ``eval()``, none is
    split over a mesh (``T5Attention.tp`` unset), no forward hook or
    pre-hook is registered on any of them or globally, and the current
    stream is not capturing. So training, every call on the CPU and every
    hooked forward run eagerly.

    One graph per signature: the shapes and dtypes of the ids and of the
    mask (and whether there is one), whether autocast is on and its dtype,
    ``torch.is_inference_mode_enabled()`` (an inference tensor cannot be
    written outside it) and the device. A signature runs eagerly the first
    time it is seen and is captured the second time: warmed up on a side
    stream, then captured there (``capture_error_mode="thread_local"``, so
    that another thread may pin memory meanwhile) under an autocast with
    its cache off, so that the graph casts the weights on each replay as
    the eager forward does on each call. At most ``MAX_GRAPHS`` graphs are
    kept; later signatures run eagerly. A replay copies the ids and the
    mask into the graph's inputs and returns a copy of its output, which
    the next replay overwrites. Those inputs and outputs are shared by
    every call: callers on several threads take turns (as the HTTP server
    does with its lock).

    The graph reads the weights where they lay at capture: a strict
    ``load_state_dict`` and an optimizer's in-place update keep them there,
    so a trainer's eval between steps sees the current weights. ``.to()``,
    ``.cuda()``, ``.half()`` and the like move them and drop every graph
    (``_apply``); anything else that replaces a parameter's tensor
    (assigning ``.data`` or a new ``nn.Parameter``, ``load_state_dict(...,
    assign=True)``) must call ``drop_graphs()``, or the graphs go on
    reading the old tensors.
    """

    MAX_GRAPHS = 8

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
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: Set[tuple] = set()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        count("text.forwards")
        if self._graphable(input_ids):
            out = self._replay(input_ids, attention_mask)
            if out is not None:
                return out
        return self._eager(input_ids, attention_mask)

    def _eager(self, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.dropout(self.embed_tokens(input_ids.long()))
        mask_bias = (attention_mask_bias(attention_mask)
                     if attention_mask is not None else None)
        position_bias = None
        for block in self.block:
            x, position_bias = block(x, position_bias, mask_bias)
        return self.dropout(self.final_layer_norm(x))

    def _graphable(self, input_ids: torch.Tensor) -> bool:
        """Whether this call may replay a graph (the class docstring)."""
        hooks = nn.modules.module
        if (not input_ids.is_cuda or torch.is_grad_enabled()
                or hooks._global_forward_hooks
                or hooks._global_forward_pre_hooks
                or torch.cuda.is_current_stream_capturing()):
            return False
        todo = [self]
        while todo:     # the stack's modules (cheaper than ``modules()``)
            m = todo.pop()
            if m is None:
                continue
            d = m.__dict__
            if (d["training"] or d["_forward_hooks"]
                    or d["_forward_pre_hooks"] or d.get("tp") is not None):
                return False
            todo.extend(d["_modules"].values())
        return True

    def drop_graphs(self) -> None:
        """Forget every captured graph and signature."""
        self._graphs.clear()
        self._seen.clear()

    def _apply(self, fn, *args, **kwargs):
        # ``.to()``, ``.cuda()``, ``.half()``... move the weights
        self.drop_graphs()
        return super()._apply(fn, *args, **kwargs)

    def _replay(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
        """The forward as a replay of this signature's graph (captured on
        its second call), or None where it runs eagerly."""
        device = input_ids.device
        cast = (torch.get_autocast_dtype(device.type)
                if torch.is_autocast_enabled(device.type) else None)
        key = (input_ids.shape, input_ids.dtype,
               None if attention_mask is None else
               (attention_mask.shape, attention_mask.dtype),
               cast, torch.is_inference_mode_enabled(), device)
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                return None
            if len(self._graphs) >= self.MAX_GRAPHS:
                return None
            entry = self._graphs[key] = self._capture(
                input_ids, attention_mask, cast)
            count("text.graph_captures")
        entry.ids.copy_(input_ids)
        if attention_mask is not None:
            entry.mask.copy_(attention_mask)
        entry.graph.replay()
        count("text.graph_replays")
        return entry.out.clone()

    def _capture(self, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor],
                 cast_dtype: Optional[torch.dtype]) -> _Graph:
        """Warm up on a side stream, then capture there. cuBLAS keeps a
        workspace per stream, which a graph's products read where they
        found it: the workspaces are dropped before the capture, so that
        the capture stream's own is drawn from the graph's private pool,
        and again after it, so that it returns there and the side stream
        holds no workspace of the common pool (32 MiB on an H100)."""
        ids = input_ids.clone()
        mask = None if attention_mask is None else attention_mask.clone()
        device = input_ids.device

        def cast():
            return (contextlib.nullcontext() if cast_dtype is None else
                    torch.autocast(device.type, dtype=cast_dtype,
                                   cache_enabled=False))

        with torch.cuda.device(device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream), cast():
                self._eager(ids, mask)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            torch._C._cuda_clearCublasWorkspaces()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"), cast():
                out = self._eager(ids, mask)
            torch._C._cuda_clearCublasWorkspaces()
        return _Graph(graph, ids, mask, out)


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
