"""A plain reference of Kimi-VL-A3B (MoonViT, the 2x2 projector and the
DeepSeek-V3 decoder) for the tests: functional float32 PyTorch over a dict
of weights, one prompt at a time, no cache, no batching, no kernel. It
follows the published equations (``models/kimi_vl.py``'s docstring writes
them out) and imports nothing of the port.

``logits(W, cfg, ids, image)`` -> [len(ids), vocab] for one prompt (token
ids, the image's placeholders among them) and its uint8 image [H, W, 3];
``weight_spec(cfg)`` names every tensor with its shape and the draw the
tests use. ``cfg`` holds ``text`` (the published decoder keys), ``vision``
(MoonViT's sizes) and ``media_placeholder_token_id``.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F


def weight_spec(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], float,
                                             float]]:
    """(name, shape, mean, std) of every weight."""
    t, v = cfg["text"], cfg["vision"]
    d, p, mlp = v["hidden_size"], v["patch_size"], v["mlp_dim"]
    n = v["pos_emb_size"]
    spec = [("vision_tower.pos_emb", (n, n, d), 0, .02),
            ("vision_tower.patch_embed.proj.weight", (d, 3, p, p), 0, .02),
            ("vision_tower.patch_embed.proj.bias", (d,), 0, .02)]
    for i in range(v["num_layers"]):
        b = f"vision_tower.blocks.{i}."
        spec += [(b + "norm0.weight", (d,), 1, .02),
                 (b + "norm0.bias", (d,), 0, .02),
                 (b + "wqkv.weight", (3 * d, d), 0, .02),
                 (b + "wqkv.bias", (3 * d,), 0, .02),
                 (b + "wo.weight", (d, d), 0, .02),
                 (b + "wo.bias", (d,), 0, .02),
                 (b + "norm1.weight", (d,), 1, .02),
                 (b + "norm1.bias", (d,), 0, .02),
                 (b + "mlp.fc0.weight", (mlp, d), 0, .02),
                 (b + "mlp.fc0.bias", (mlp,), 0, .02),
                 (b + "mlp.fc1.weight", (d, mlp), 0, .02),
                 (b + "mlp.fc1.bias", (d,), 0, .02)]
    m = d * v["merge"] ** 2
    h = t["hidden_size"]
    spec += [("vision_tower.final_layernorm.weight", (d,), 1, .02),
             ("vision_tower.final_layernorm.bias", (d,), 0, .02),
             ("multi_modal_projector.pre_norm.weight", (d,), 1, .02),
             ("multi_modal_projector.pre_norm.bias", (d,), 0, .02),
             ("multi_modal_projector.linear_1.weight", (m, m), 0, .02),
             ("multi_modal_projector.linear_1.bias", (m,), 0, .02),
             ("multi_modal_projector.linear_2.weight", (h, m), 0, .02),
             ("multi_modal_projector.linear_2.bias", (h,), 0, .02),
             ("language_model.embed_tokens.weight",
              (t["vocab_size"], h), 0, .02)]
    H, r = t["num_attention_heads"], t["kv_lora_rank"]
    nope, rope, vd = (t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                      t["v_head_dim"])
    E, w = t["n_routed_experts"], t["moe_intermediate_size"]
    for i in range(t["num_hidden_layers"]):
        b = f"language_model.layers.{i}."
        spec += [(b + "input_layernorm.weight", (h,), 1, .02),
                 (b + "self_attn.q_proj.weight", (H * (nope + rope), h),
                  0, .02),
                 (b + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, h),
                  0, .02),
                 (b + "self_attn.kv_a_layernorm.weight", (r,), 1, .02),
                 (b + "self_attn.kv_b_proj.weight", (H * (nope + vd), r),
                  0, .02),
                 (b + "self_attn.o_proj.weight", (h, H * vd), 0, .02),
                 (b + "post_attention_layernorm.weight", (h,), 1, .02)]
        if i < t["first_k_dense_replace"]:
            f = t["intermediate_size"]
            spec += [(b + "mlp.gate_proj.weight", (f, h), 0, .02),
                     (b + "mlp.up_proj.weight", (f, h), 0, .02),
                     (b + "mlp.down_proj.weight", (h, f), 0, .02)]
        else:
            s = w * t["n_shared_experts"]
            spec += [(b + "mlp.gate.weight", (E, h), 0, .02),
                     (b + "mlp.gate.e_score_correction_bias", (E,), 0, .05),
                     (b + "mlp.experts.gate_up_proj", (E, 2 * w, h), 0, .02),
                     (b + "mlp.experts.down_proj", (E, h, w), 0, .02),
                     (b + "mlp.shared_experts.gate_proj.weight", (s, h),
                      0, .02),
                     (b + "mlp.shared_experts.up_proj.weight", (s, h),
                      0, .02),
                     (b + "mlp.shared_experts.down_proj.weight", (h, s),
                      0, .02)]
    spec += [("language_model.norm.weight", (h,), 1, .02),
             ("lm_head.weight", (t["vocab_size"], h), 0, .02)]
    return spec


def draw(cfg: Mapping, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=gen) * std + mean
            for name, shape, mean, std in weight_spec(cfg)}


# ------------------------------------------------------------------ vision


def _rope2d(x: torch.Tensor, gh: int, gw: int, theta: float) -> torch.Tensor:
    """x [S, heads, D], patches in row-major order: pair j of the head's
    dims turns by the column (j even) or the row (j odd) times
    theta^(-4 * (j // 2) / D)."""
    D = x.shape[-1]
    out = torch.empty_like(x)
    for s in range(x.shape[0]):
        row, col = divmod(s, gw)
        for j in range(D // 2):
            f = theta ** (-4.0 * (j // 2) / D)
            a = (col if j % 2 == 0 else row) * f
            x0, x1 = x[s, :, 2 * j], x[s, :, 2 * j + 1]
            out[s, :, 2 * j] = x0 * math.cos(a) - x1 * math.sin(a)
            out[s, :, 2 * j + 1] = x0 * math.sin(a) + x1 * math.cos(a)
    return out


def image_tokens(W: Mapping, cfg: Mapping, image: torch.Tensor
                 ) -> torch.Tensor:
    """uint8 [H, W, 3] -> [gh/2 * gw/2, text hidden]."""
    v = cfg["vision"]
    p, d, heads = v["patch_size"], v["hidden_size"], v["num_heads"]
    eps = v["layer_norm_eps"]
    x = (image.float() / 255.0 - 0.5) / 0.5
    x = x.permute(2, 0, 1)[None]
    gh, gw = x.shape[2] // p, x.shape[3] // p
    h = F.conv2d(x, W["vision_tower.patch_embed.proj.weight"],
                 W["vision_tower.patch_embed.proj.bias"], stride=p)
    h = h[0].flatten(1).t()                                  # [S, d]
    table = W["vision_tower.pos_emb"]
    if (gh, gw) != tuple(table.shape[:2]):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw),
                              mode="bicubic")[0].permute(1, 2, 0)
    h = h + table.reshape(gh * gw, d)
    for i in range(v["num_layers"]):
        b = f"vision_tower.blocks.{i}."
        y = F.layer_norm(h, (d,), W[b + "norm0.weight"], W[b + "norm0.bias"],
                         eps)
        qkv = y @ W[b + "wqkv.weight"].t() + W[b + "wqkv.bias"]
        q, k, val = qkv.view(-1, 3, heads, d // heads).unbind(1)
        q = _rope2d(q, gh, gw, v["rope_theta"]).transpose(0, 1)
        k = _rope2d(k, gh, gw, v["rope_theta"]).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(d // heads),
                            dim=-1) @ val.transpose(0, 1)
        h = h + att.transpose(0, 1).reshape(-1, d) @ W[b + "wo.weight"].t() \
            + W[b + "wo.bias"]
        y = F.layer_norm(h, (d,), W[b + "norm1.weight"], W[b + "norm1.bias"],
                         eps)
        y = F.gelu(y @ W[b + "mlp.fc0.weight"].t() + W[b + "mlp.fc0.bias"],
                   approximate="tanh")
        h = h + y @ W[b + "mlp.fc1.weight"].t() + W[b + "mlp.fc1.bias"]
    h = F.layer_norm(h, (d,), W["vision_tower.final_layernorm.weight"],
                     W["vision_tower.final_layernorm.bias"], eps)
    pre = "multi_modal_projector."
    h = F.layer_norm(h, (d,), W[pre + "pre_norm.weight"],
                     W[pre + "pre_norm.bias"], 1e-5).view(gh, gw, d)
    merged = []
    for r in range(0, gh, 2):
        for c in range(0, gw, 2):
            merged.append(torch.cat([h[r, c], h[r, c + 1], h[r + 1, c],
                                     h[r + 1, c + 1]]))
    m = torch.stack(merged)
    m = F.gelu(m @ W[pre + "linear_1.weight"].t() + W[pre + "linear_1.bias"])
    return m @ W[pre + "linear_2.weight"].t() + W[pre + "linear_2.bias"]


# ------------------------------------------------------------------ decoder


def _rms(x, w, eps):
    return w * x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, ..., D] at positions 0..S-1: DeepSeek-V3's de-interleave, then
    rotate_half."""
    S, D = x.shape[0], x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32) / D)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1).view(S, *[1] * (x.dim() - 2), D)
    half = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * ang.cos() + half * ang.sin()


def _swiglu(x, g, u, d):
    return (F.silu(x @ g.t()) * (x @ u.t())) @ d.t()


def moe(W: Mapping, b: str, t: Mapping, x: torch.Tensor) -> torch.Tensor:
    """One token at a time, each through its chosen experts."""
    w = t["moe_intermediate_size"]
    out = _swiglu(x, W[b + "shared_experts.gate_proj.weight"],
                  W[b + "shared_experts.up_proj.weight"],
                  W[b + "shared_experts.down_proj.weight"])
    scores = torch.sigmoid(x @ W[b + "gate.weight"].t())
    choice = scores + W[b + "gate.e_score_correction_bias"]
    for n in range(x.shape[0]):
        top = choice[n].topk(t["num_experts_per_tok"]).indices
        weights = scores[n, top]
        weights = weights / (weights.sum() + 1e-20) \
            * t["routed_scaling_factor"]
        for e, we in zip(top.tolist(), weights):
            gu = W[b + "experts.gate_up_proj"][e]
            out[n] += we * _swiglu(x[n], gu[:w], gu[w:],
                                   W[b + "experts.down_proj"][e])
    return out


def logits(W: Mapping, cfg: Mapping, ids: List[int], image: torch.Tensor
           ) -> torch.Tensor:
    t = cfg["text"]
    eps, H = t["rms_norm_eps"], t["num_attention_heads"]
    nope, rope, vd, r = (t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                         t["v_head_dim"], t["kv_lora_rank"])
    ids_t = torch.tensor(ids)
    h = W["language_model.embed_tokens.weight"][ids_t].clone()
    slots = ids_t == cfg["media_placeholder_token_id"]
    h[slots] = image_tokens(W, cfg, image)[:int(slots.sum())]
    S = len(ids)
    causal = torch.ones(S, S).tril().bool()
    for i in range(t["num_hidden_layers"]):
        b = f"language_model.layers.{i}."
        x = _rms(h, W[b + "input_layernorm.weight"], eps)
        q = (x @ W[b + "self_attn.q_proj.weight"].t()).view(S, H, nope + rope)
        kv_a = x @ W[b + "self_attn.kv_a_proj_with_mqa.weight"].t()
        c = _rms(kv_a[:, :r], W[b + "self_attn.kv_a_layernorm.weight"], eps)
        kv = (c @ W[b + "self_attn.kv_b_proj.weight"].t()).view(S, H, -1)
        k_pe = _rope(kv_a[:, None, r:], t["rope_theta"]).expand(S, H, rope)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], t["rope_theta"])],
                      dim=-1)
        k = torch.cat([kv[..., :nope], k_pe], dim=-1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rope)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hqk,khd->qhd", p, kv[..., nope:]).reshape(S, -1)
        h = h + o @ W[b + "self_attn.o_proj.weight"].t()
        x = _rms(h, W[b + "post_attention_layernorm.weight"], eps)
        if i < t["first_k_dense_replace"]:
            h = h + _swiglu(x, W[b + "mlp.gate_proj.weight"],
                            W[b + "mlp.up_proj.weight"],
                            W[b + "mlp.down_proj.weight"])
        else:
            h = h + moe(W, b + "mlp.", t, x)
    h = _rms(h, W["language_model.norm.weight"], eps)
    return h @ W["lm_head.weight"].t()
