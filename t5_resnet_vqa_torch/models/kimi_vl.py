"""Kimi-VL-A3B-Instruct: the MoonViT image encoder, its 2x2 patch merge and
MLP projector, and a DeepSeek-V3 decoder (multi-head latent attention,
sparse experts with shared experts), served through a latent KV cache.

Sizes: ``KimiVLConfig`` (the published ``config.json`` of
moonshotai/Kimi-VL-A3B-Instruct for the decoder; the Kimi-VL technical
report, arXiv:2504.07491, for MoonViT, which starts from SigLIP-SO400M).

MoonViT, over an image of H x W pixels (multiples of 28), normalised as
``(x / 255 - 0.5) / 0.5``, cut into 14 x 14 patches on a gh x gw grid:

    h0 = P x_patch + b_P + interp(T)          (T: a 64 x 64 learned table,
                                               bicubic to gh x gw)
    for 27 layers (pre-LayerNorm, width 1152, 16 heads of 72):
        q, k, v = W_qkv LN0(h) + b_qkv
        q, k   <- rope2d(q), rope2d(k)
        h      = h + W_o softmax(q k^T / sqrt(72)) v + b_o
        h      = h + W_2 gelu_tanh(W_1 LN1(h) + b_1) + b_2    (width 4304)
    h = LN_final(h)

``rope2d`` rotates each head's 36 pairs of dims (2j, 2j+1) by the patch's
column times f_{j/2} for even j and its row times f_{(j-1)/2} for odd j,
``f_i = 10000^(-4i / 72)``: half the pairs by column, half by row (the
published ``Rope2DPosEmb``).

Projector: ``LN(h)`` per patch, then each 2 x 2 block of patches
concatenated in the order (r, c), (r, c+1), (r+1, c), (r+1, c+1) into 4608
values, then ``W_b gelu(W_a m + b_a) + b_b`` (exact GELU; 4608 -> 4608 ->
2048): gh/2 * gw/2 image tokens, which take the places of the prompt's
``<|media_pad|>`` tokens, in order.

Decoder (DeepSeek-V3, 27 layers, hidden 2048):

    h = h + MLA(RMSNorm(h));  h = h + FFN(RMSNorm(h))
    logits = W_head RMSNorm(h)                (untied, 163840)

``RMSNorm(x) = w * x / sqrt(mean(x^2) + 1e-5)``, its statistics in fp32.
FFN is a SwiGLU of width 11264 in layer 0 and the sparse experts
(``ops/moe.py``: sigmoid router, top-6 of 64 by score plus correction
bias, weights normalised and scaled by 2.446, experts of width 1408, a
shared expert of width 2816) in layers 1-26. MLA, 16 heads, no query
compression:

    [q_nope | q_pe] = W_q x                   (128 + 64 a head)
    [c | k_pe]      = W_kva x                 (512 + 64, k_pe shared)
    c               = RMSNorm(c)
    [k_nope | v]    = W_kvb c                 (128 + 128 a head)
    q_pe, k_pe      <- rope(q_pe), rope(k_pe) (theta 800000)
    o = softmax([q_nope|q_pe] . [k_nope|k_pe] / sqrt(192), causal) v
    out = W_o o

``rope`` is the published DeepSeek-V3 code's: the 64 dims are first
de-interleaved (even dims, then odd), then rotated in halves,
``x cos + rotate_half(x) sin`` with ``cos = cos(p * [f, f])``,
``f_i = 800000^(-2i / 64)``.

The cache holds, a token a layer, the normalised ``c`` and the rotated
``k_pe``: 576 values. Prefill (``prefill``) runs the prompt through the
unfolded form above (``ops/mla.mla_prefill``) and writes the cache; a
decode step (``decode_step``) folds W_kvb's key half into the query,
``q_lat = W_uk^T q_nope``, scores ``q_lat . c + q_pe . k_pe`` over the
cache, and takes the weighted sum of ``c`` through W_kvb's value half
(``ops/mla.mla_decode``). Both are the same products in another order.

Precision: the weights are held in the dtype the model is built in (bf16
to serve); the router, the RMSNorm statistics, the softmaxes and the
rotations run in fp32, and the logits are returned in fp32.

Departures from the published code, none of them in the arithmetic:

* the experts' weights are stacked, ``experts.gate_up_proj`` [64, 2816,
  2048] (each expert's gate rows, then its up rows) and
  ``experts.down_proj`` [64, 2048, 1408], where the published checkpoint
  keeps one module per expert; the decoder's keys drop the
  ``language_model.model.`` prefix (``language_model.layers.*``,
  ``lm_head.weight``). Loading the published checkpoint is not written.
* MoonViT runs a batch of images of one size as a batch (the published
  code packs images of any sizes into one sequence with per-image
  boundaries): the same attention within each image.
* the image tokens are placed by each row's count of placeholders so far,
  where the published code scatters them through a boolean mask: the
  same places.

Ranges: ``model.vision`` (MoonViT and the projector), ``model.prefill``,
``model.decode`` (one a step), and the ops' ``op.mla``,
``op.mla_decode`` and ``op.moe``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mla import mla_decode, mla_prefill
from ..ops.moe import moe, swiglu
from ..utils.profiling import span
from .image_input import finalize_image_input

IMAGE_MEAN_STD = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))


@dataclasses.dataclass(frozen=True)
class MoonViTConfig:
    patch_size: int = 14
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    mlp_dim: int = 4304
    pos_emb_size: int = 64
    rope_theta: float = 10000.0
    merge: int = 2
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class KimiTextConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0


# the published config's values that this module implements and no other
_FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid", "n_group": 1,
          "topk_group": 1, "norm_topk_prob": True, "rope_scaling": None,
          "topk_method": "noaux_tc", "hidden_act": "silu",
          "attention_bias": False, "tie_word_embeddings": False,
          "moe_layer_freq": 1}


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    text: KimiTextConfig = KimiTextConfig()
    vision: MoonViTConfig = MoonViTConfig()
    projector_eps: float = 1e-5
    media_placeholder_token_id: int = 163605
    # the chat prompt's special ids ((name, id) pairs over the collate's
    # defaults) and the most tokens of a question in it
    special_tokens: Tuple[Tuple[str, int], ...] = ()
    max_question_tokens: int = 23

    @classmethod
    def from_dict(cls, text: Mapping, vision: Mapping,
                  media_placeholder_token_id: int = 163605,
                  special_tokens: Optional[Mapping[str, int]] = None,
                  max_question_tokens: int = 23) -> "KimiVLConfig":
        """From the published decoder keys (``text``; keys this module does
        not read are ignored, keys it fixes are checked), MoonViT's sizes
        (``vision``) and the prompt's ids and question length."""
        for key, want in _FIXED.items():
            if key in text and text[key] != want:
                raise NotImplementedError(
                    f"Kimi-VL with {key}={text[key]!r} (this port runs "
                    f"{want!r})")
        fields = {f.name for f in dataclasses.fields(KimiTextConfig)}
        return cls(KimiTextConfig(**{k: v for k, v in text.items()
                                     if k in fields}),
                   MoonViTConfig(**vision),
                   media_placeholder_token_id=media_placeholder_token_id,
                   special_tokens=tuple(sorted((special_tokens or {}).items())),
                   max_question_tokens=max_question_tokens)


# ------------------------------------------------------------------ pieces


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                + self.eps)
        return self.weight * x32.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) [..., dim] of the decoder's rotation at
    ``positions``."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device,
                                       dtype=torch.float32) / dim)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek-V3's rotation of ``x`` [..., dim]: de-interleave, then
    ``x cos + rotate_half(x) sin`` in fp32; ``cos``, ``sin`` broadcast."""
    x32 = x.float().unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    a, b = x32.chunk(2, dim=-1)
    return (x32 * cos + torch.cat([-b, a], dim=-1) * sin).to(x.dtype)


def rope2d_tables(gh: int, gw: int, head_dim: int, theta: float, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) [gh * gw, head_dim / 2] of MoonViT's rotation: pair
    2i turns by the column, pair 2i + 1 by the row, each at f_i."""
    freqs = 1.0 / theta ** (torch.arange(0, head_dim, 4, device=device,
                                         dtype=torch.float32)
                            [:head_dim // 4] / head_dim)
    rows = torch.arange(gh, device=device).repeat_interleave(gw).float()
    cols = torch.arange(gw, device=device).repeat(gh).float()
    angle = torch.stack([cols[:, None] * freqs, rows[:, None] * freqs],
                        dim=-1).flatten(1)
    return angle.cos(), angle.sin()


def apply_rope2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """Rotate the pairs (2j, 2j+1) of ``x`` [B, H, S, D] by the angles of
    ``cos``/``sin`` [S, D/2], in fp32."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)


# ------------------------------------------------------------------ MoonViT


class MoonViTBlock(nn.Module):
    def __init__(self, c: MoonViTConfig):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_heads
        self.norm0 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.wqkv = nn.Linear(d, 3 * d)
        self.wo = nn.Linear(d, d)
        self.norm1 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.mlp = nn.ModuleDict({"fc0": nn.Linear(d, c.mlp_dim),
                                  "fc1": nn.Linear(c.mlp_dim, d)})

    def forward(self, h: torch.Tensor, cos, sin) -> torch.Tensor:
        B, S, d = h.shape
        qkv = self.wqkv(self.norm0(h)).view(B, S, 3, self.heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        q, k = apply_rope2d(q, cos, sin), apply_rope2d(k, cos, sin)
        o = F.scaled_dot_product_attention(q, k, v)
        h = h + self.wo(o.transpose(1, 2).reshape(B, S, d))
        x = self.mlp["fc0"](self.norm1(h))
        return h + self.mlp["fc1"](F.gelu(x, approximate="tanh"))


class MoonViT(nn.Module):
    def __init__(self, c: MoonViTConfig):
        super().__init__()
        self.config = c
        d, p = c.hidden_size, c.patch_size
        self.patch_embed = nn.ModuleDict({
            "proj": nn.Conv2d(3, d, p, stride=p)})
        self.pos_emb = nn.Parameter(
            torch.empty(c.pos_emb_size, c.pos_emb_size, d).normal_(0, 0.02))
        self.blocks = nn.ModuleList(MoonViTBlock(c)
                                    for _ in range(c.num_layers))
        self.final_layernorm = nn.LayerNorm(d, eps=c.layer_norm_eps)

    def position_table(self, gh: int, gw: int) -> torch.Tensor:
        """[gh * gw, d]: the learned table, bicubic to the grid where it
        differs (in fp32)."""
        t = self.pos_emb
        if (gh, gw) != tuple(t.shape[:2]):
            t = F.interpolate(t.float().permute(2, 0, 1)[None], size=(gh, gw),
                              mode="bicubic")[0].permute(1, 2, 0)
        return t.reshape(gh * gw, -1).to(self.pos_emb.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised images [B, H, W, 3] -> patch states [B, gh, gw, d]."""
        c = self.config
        B, H, W, _ = pixels.shape
        p, gh, gw = c.patch_size, H // c.patch_size, W // c.patch_size
        proj = self.patch_embed["proj"]
        patches = pixels.view(B, gh, p, gw, p, 3).permute(0, 1, 3, 5, 2, 4)
        h = F.linear(patches.reshape(B, gh * gw, 3 * p * p),
                     proj.weight.reshape(c.hidden_size, -1), proj.bias)
        h = h + self.position_table(gh, gw)
        cos, sin = rope2d_tables(gh, gw, c.hidden_size // c.num_heads,
                                 c.rope_theta, h.device)
        for block in self.blocks:
            h = block(h, cos, sin)
        return self.final_layernorm(h).view(B, gh, gw, -1)


class Projector(nn.Module):
    def __init__(self, vision: MoonViTConfig, text_hidden: int, eps: float):
        super().__init__()
        d = vision.hidden_size * vision.merge ** 2
        self.merge = vision.merge
        self.pre_norm = nn.LayerNorm(vision.hidden_size, eps=eps)
        self.linear_1 = nn.Linear(d, d)
        self.linear_2 = nn.Linear(d, text_hidden)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """Patch states [B, gh, gw, d] -> image tokens [B, gh*gw/4, 2048]."""
        B, gh, gw, d = h.shape
        m = self.merge
        h = self.pre_norm(h).view(B, gh // m, m, gw // m, m, d)
        h = h.permute(0, 1, 3, 2, 4, 5).reshape(B, (gh // m) * (gw // m), -1)
        return self.linear_2(F.gelu(self.linear_1(h)))


# ------------------------------------------------------------------ decoder


class MLA(nn.Module):
    def __init__(self, c: KimiTextConfig):
        super().__init__()
        self.c = c
        H, d = c.num_attention_heads, c.hidden_size
        self.qk_dim = c.qk_nope_head_dim + c.qk_rope_head_dim
        self.scale = self.qk_dim ** -0.5
        self.q_proj = nn.Linear(d, H * self.qk_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(
            d, c.kv_lora_rank + c.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            c.kv_lora_rank, H * (c.qk_nope_head_dim + c.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(H * c.v_head_dim, d, bias=False)

    def _latent(self, x, cos, sin):
        """(q_nope, rotated q_pe, normalised c, rotated k_pe) of ``x``
        [B, S, d]: q parts [B, S, H, *], c [B, S, 512], k_pe [B, S, 64]."""
        c = self.c
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, c.num_attention_heads, self.qk_dim)
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
        lat, k_pe = self.kv_a_proj_with_mqa(x).split(
            [c.kv_lora_rank, c.qk_rope_head_dim], -1)
        cos, sin = cos[:, :, None], sin[:, :, None]      # over the heads
        return (q_nope, apply_rope(q_pe, cos, sin), self.kv_a_layernorm(lat),
                apply_rope(k_pe[:, :, None], cos, sin)[:, :, 0])

    def prefill(self, x, cos, sin, cache: torch.Tensor) -> torch.Tensor:
        """The prompt ``x`` [B, S, d] (positions 0..S-1); writes its latent
        entries into ``cache[:, :S]``."""
        c = self.c
        B, S, _ = x.shape
        H = c.num_attention_heads
        q_nope, q_pe, lat, k_pe = self._latent(x, cos, sin)
        cache[:, :S] = torch.cat([lat, k_pe], dim=-1)
        kv = self.kv_b_proj(lat).view(B, S, H, -1)
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], -1)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, H, -1)],
                      dim=-1).transpose(1, 2)
        o = mla_prefill(q, k, v.transpose(1, 2), self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(B, S, -1))

    def decode(self, x, cos, sin, cache: torch.Tensor, positions, length: int
               ) -> torch.Tensor:
        """One token a row, ``x`` [B, 1, d] at ``positions`` [B]: its entry
        written there, attention over ``cache[:, :length]``."""
        c = self.c
        B = x.shape[0]
        H, C = c.num_attention_heads, c.kv_lora_rank
        q_nope, q_pe, lat, k_pe = self._latent(x, cos, sin)
        rows = torch.arange(B, device=x.device)
        cache[rows, positions] = torch.cat([lat, k_pe], dim=-1)[:, 0]
        w = self.kv_b_proj.weight.view(H, -1, C)
        w_uk, w_uv = w.split([c.qk_nope_head_dim, c.v_head_dim], dim=1)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)   # [H, B, C]
        q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
        o_lat = mla_decode(q, cache[:, :length], positions, C, self.scale)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))
        return self.o_proj(o.transpose(0, 1).reshape(B, 1, -1))


class DenseMLP(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def weights(self):
        return (self.gate_proj.weight, self.up_proj.weight,
                self.down_proj.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, *self.weights())


class MoE(nn.Module):
    def __init__(self, c: KimiTextConfig):
        super().__init__()
        E, d, w = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.top_k, self.scale = c.num_experts_per_tok, c.routed_scaling_factor
        self.gate = nn.Linear(d, E, bias=False)
        self.gate.e_score_correction_bias = nn.Parameter(torch.zeros(E))
        self.experts = nn.Module()
        self.experts.gate_up_proj = nn.Parameter(
            torch.empty(E, 2 * w, d).normal_(0, 0.02))
        self.experts.down_proj = nn.Parameter(
            torch.empty(E, d, w).normal_(0, 0.02))
        self.shared_experts = DenseMLP(d, w * c.n_shared_experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        out = moe(x.reshape(-1, shape[-1]), self.gate.weight,
                  self.gate.e_score_correction_bias,
                  self.experts.gate_up_proj, self.experts.down_proj,
                  self.shared_experts.weights(), self.top_k, self.scale)
        return out.view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, c: KimiTextConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size,
                                                c.rms_norm_eps)
        self.mlp = DenseMLP(c.hidden_size, c.intermediate_size) \
            if index < c.first_k_dense_replace else MoE(c)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.mlp(self.post_attention_layernorm(h))

    def prefill(self, h, cos, sin, cache):
        h = h + self.self_attn.prefill(self.input_layernorm(h), cos, sin,
                                       cache)
        return self._ffn(h)

    def decode(self, h, cos, sin, cache, positions, length):
        h = h + self.self_attn.decode(self.input_layernorm(h), cos, sin,
                                      cache, positions, length)
        return self._ffn(h)


class KimiDecoder(nn.Module):
    def __init__(self, c: KimiTextConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(c, i)
                                    for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps)


# ------------------------------------------------------------------ model


class KimiVLModel(nn.Module):
    """Kimi-VL-A3B: ``encode_images``, then ``prefill`` over the prompt and
    ``decode_step`` through the cache (``models/generation.py`` drives
    them); ``forward`` gives every position's logits in one pass (no
    cache kept). Build it on ``meta`` and load a ``state_dict`` with
    ``assign=True`` to hold no second copy of the weights."""

    def __init__(self, config: KimiVLConfig = KimiVLConfig()):
        super().__init__()
        self.config = config
        t = config.text
        self.vision_tower = MoonViT(config.vision)
        self.multi_modal_projector = Projector(config.vision, t.hidden_size,
                                               config.projector_eps)
        self.language_model = KimiDecoder(t)
        self.lm_head = nn.Linear(t.hidden_size, t.vocab_size, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    @span("model.vision")
    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """uint8 images [B, H, W, 3] (or already normalised floats) ->
        image tokens [B, n, 2048]."""
        x = finalize_image_input(pixel_values, IMAGE_MEAN_STD)
        return self.multi_modal_projector(
            self.vision_tower(x.to(self.dtype)))

    def new_cache(self, batch: int, length: int) -> torch.Tensor:
        """[layers, B, length, 576] latent entries, zero: a masked position
        still meets a weight of 0 in the weighted sum, which must not be
        multiplied into a NaN left in unset memory."""
        t = self.config.text
        return torch.zeros(t.num_hidden_layers, batch, length,
                           t.kv_lora_rank + t.qk_rope_head_dim,
                           dtype=self.dtype, device=self.lm_head.weight.device)

    def _embed(self, input_ids: torch.Tensor, images: torch.Tensor
               ) -> torch.Tensor:
        """Token embeddings with each row's placeholders replaced by its
        image tokens, in order."""
        h = self.language_model.embed_tokens(input_ids)
        slot = input_ids == self.config.media_placeholder_token_id
        index = (slot.cumsum(1) - 1).clamp(min=0)
        picked = images.to(h.dtype).gather(
            1, index[..., None].expand(-1, -1, h.shape[-1]))
        return torch.where(slot[..., None], picked, h)

    def _rope(self, positions: torch.Tensor):
        t = self.config.text
        return rope_tables(positions, t.qk_rope_head_dim, t.rope_theta)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.language_model.norm(h)).float()

    def _prompt(self, input_ids, images, cache) -> torch.Tensor:
        B, S = input_ids.shape
        h = self._embed(input_ids, images)
        cos, sin = self._rope(torch.arange(S, device=h.device)[None])
        for i, layer in enumerate(self.language_model.layers):
            h = layer.prefill(h, cos, sin, cache[i])
        return h

    @span("model.prefill")
    def prefill(self, input_ids: torch.Tensor, lengths: torch.Tensor,
                images: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """Prompts ``input_ids`` [B, S] (padded on the right; row b's
        prompt is its first ``lengths[b]`` ids) -> fp32 logits [B, V] at
        each row's last prompt position; fills ``cache[:, :, :S]``."""
        h = self._prompt(input_ids, images, cache)
        rows = torch.arange(h.shape[0], device=h.device)
        return self._logits(h[rows, lengths - 1])

    @span("model.decode")
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor,
                    cache: torch.Tensor, length: int) -> torch.Tensor:
        """``tokens`` [B] at ``positions`` [B] -> fp32 logits [B, V]; each
        row attends to its cache entries up to its position, all within
        the first ``length``."""
        h = self.language_model.embed_tokens(tokens)[:, None]
        cos, sin = self._rope(positions[:, None])
        for i, layer in enumerate(self.language_model.layers):
            h = layer.decode(h, cos, sin, cache[i], positions, length)
        return self._logits(h[:, 0])

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor
                ) -> torch.Tensor:
        """fp32 logits [B, S, V] at every position of ``input_ids``."""
        images = self.encode_images(pixel_values)
        cache = self.new_cache(*input_ids.shape)
        return self._logits(self._prompt(input_ids, images, cache))


def build_kimi_vl(config: KimiVLConfig = KimiVLConfig(),
                  device="meta", dtype: torch.dtype = torch.bfloat16
                  ) -> KimiVLModel:
    """The model on ``device`` in ``dtype``; on ``meta`` (the default) it
    holds no memory until a ``state_dict`` is loaded with ``assign=True``."""
    with torch.device(device):
        model = KimiVLModel(config)
    return model.to(dtype)


__all__ = ["KimiTextConfig", "KimiVLConfig", "KimiVLModel", "MoonViTConfig",
           "apply_rope", "apply_rope2d", "build_kimi_vl", "rope2d_tables",
           "rope_tables"]
