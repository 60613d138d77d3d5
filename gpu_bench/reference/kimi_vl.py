"""The plain reference of ``kimivl_a3b_instruct``: Kimi-VL-A3B-Instruct
(MoonViT, the 2x2 projector, the DeepSeek-V3 decoder with latent attention
and sparse experts) in float32 with TF32 off, functional over a mapping of
weights, with no cache and no padded batch: each prompt runs at its own
length, through every layer with its whole sequence, and each expert takes
the rows routed to it. The equations are the published ones (Kimi-VL
technical report, arXiv:2504.07491; DeepSeek-V3's published modelling
code), written out in the program's ``models/kimi_vl.py``; this file
imports nothing of the program.

The weights come as a mapping; ``generate_logprobs`` reads each layer's
tensors once per block of pairs, when it reaches the layer, so a mapping
that draws a tensor when it is read (``configs/kimivl_a3b_instruct/
model.py``'s ``LazyWeights``) holds one layer at a time: 16.4 B
parameters in float32 would take 65.6 GB.

The prompt is derived here again from the question's text, with the
configuration's special ids (``assumed``) and the offline hash tokenizer
(``inputs.hash_tokenize``), and the image is padded here to multiples of
28 pixels with zeros at the bottom and right.

Each sparse layer takes the top-k of its own scores, or the experts it is
given a position (the program's, recorded as it ran): then it reads how
far each given choice lies below its own k-th best (the route gap), and
computes the layer with the given experts, so that a choice between
near-tied experts, which the precision decides, does not move every later
layer.

Every product goes through a ``Precision`` (``nn.py``): the control runs
this reference as an fp8 step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpu_bench.reference.inputs import hash_tokenize
from gpu_bench.reference.nn import Precision, layer_norm, linear, rms_norm

Spec = List[Tuple[str, Tuple[int, ...], str, float, float]]

# standard deviations of the random weights (assumed: no checkpoint)
LINEAR_STD, NORM_STD, BIAS_STD, ROUTER_BIAS_STD = 0.02, 0.02, 0.02, 0.05


def _vision_spec(v: Mapping) -> Spec:
    d, p, mlp, n = (v["hidden_size"], v["patch_size"], v["mlp_dim"],
                    v["pos_emb_size"])
    w = lambda name, shape: (name, shape, "normal", 0.0, LINEAR_STD)
    b = lambda name, shape: (name, shape, "normal", 0.0, BIAS_STD)
    g = lambda name, shape: (name, shape, "normal", 1.0, NORM_STD)
    spec = [w("vision_tower.pos_emb", (n, n, d)),
            w("vision_tower.patch_embed.proj.weight", (d, 3, p, p)),
            b("vision_tower.patch_embed.proj.bias", (d,))]
    for i in range(v["num_layers"]):
        k = f"vision_tower.blocks.{i}."
        spec += [g(k + "norm0.weight", (d,)), b(k + "norm0.bias", (d,)),
                 w(k + "wqkv.weight", (3 * d, d)),
                 b(k + "wqkv.bias", (3 * d,)),
                 w(k + "wo.weight", (d, d)), b(k + "wo.bias", (d,)),
                 g(k + "norm1.weight", (d,)), b(k + "norm1.bias", (d,)),
                 w(k + "mlp.fc0.weight", (mlp, d)),
                 b(k + "mlp.fc0.bias", (mlp,)),
                 w(k + "mlp.fc1.weight", (d, mlp)),
                 b(k + "mlp.fc1.bias", (d,))]
    return spec + [g("vision_tower.final_layernorm.weight", (d,)),
                   b("vision_tower.final_layernorm.bias", (d,))]


def weight_spec(cfg: Mapping) -> Spec:
    """(name, shape, "normal", mean, std) of every weight, in the program's
    ``state_dict`` order."""
    v = cfg["vision"]
    d, h = v["hidden_size"], cfg["hidden_size"]
    m = d * v["merge"] ** 2
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    E, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    s = w * cfg["n_shared_experts"]
    lin = lambda name, shape: (name, shape, "normal", 0.0, LINEAR_STD)
    bias = lambda name, shape: (name, shape, "normal", 0.0, BIAS_STD)
    gain = lambda name, shape: (name, shape, "normal", 1.0, NORM_STD)
    pre = "multi_modal_projector."
    spec = _vision_spec(v) + [
        gain(pre + "pre_norm.weight", (d,)),
        bias(pre + "pre_norm.bias", (d,)),
        lin(pre + "linear_1.weight", (m, m)),
        bias(pre + "linear_1.bias", (m,)),
        lin(pre + "linear_2.weight", (h, m)),
        bias(pre + "linear_2.bias", (h,)),
        lin("language_model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        k = f"language_model.layers.{i}."
        spec += [gain(k + "input_layernorm.weight", (h,)),
                 lin(k + "self_attn.q_proj.weight", (H * (nope + rope), h)),
                 lin(k + "self_attn.kv_a_proj_with_mqa.weight",
                     (r + rope, h)),
                 gain(k + "self_attn.kv_a_layernorm.weight", (r,)),
                 lin(k + "self_attn.kv_b_proj.weight", (H * (nope + vd), r)),
                 lin(k + "self_attn.o_proj.weight", (h, H * vd)),
                 gain(k + "post_attention_layernorm.weight", (h,))]
        if i < cfg["first_k_dense_replace"]:
            f = cfg["intermediate_size"]
            spec += [lin(k + "mlp.gate_proj.weight", (f, h)),
                     lin(k + "mlp.up_proj.weight", (f, h)),
                     lin(k + "mlp.down_proj.weight", (h, f))]
        else:
            spec += [lin(k + "mlp.gate.weight", (E, h)),
                     (k + "mlp.gate.e_score_correction_bias", (E,), "normal",
                      0.0, ROUTER_BIAS_STD),
                     lin(k + "mlp.experts.gate_up_proj", (E, 2 * w, h)),
                     lin(k + "mlp.experts.down_proj", (E, h, w)),
                     lin(k + "mlp.shared_experts.gate_proj.weight", (s, h)),
                     lin(k + "mlp.shared_experts.up_proj.weight", (s, h)),
                     lin(k + "mlp.shared_experts.down_proj.weight", (h, s))]
    return spec + [gain("language_model.norm.weight", (h,)),
                   lin("lm_head.weight", (cfg["vocab_size"], h))]


# ------------------------------------------------------------------ inputs


def prompt_ids(cfg: Mapping, question: str, image_tokens: int) -> List[int]:
    """The chat prompt around ``image_tokens`` image placeholders
    (``assumed``)."""
    sp = cfg["special_tokens"]

    def words(text: str, n: int) -> List[int]:
        ids, _ = hash_tokenize([text], n + 1, {})
        return [int(t) for t in ids[0] if t > 1]     # no pad (0), no end (1)

    return ([sp["im_user"], *words("user", 8), sp["im_middle"],
             sp["media_start"], *words("image", 8), sp["media_content"]]
            + [cfg["media_placeholder_token_id"]] * image_tokens
            + [sp["media_end"]]
            + words(question, cfg["max_question_tokens"])
            + [sp["im_end"], sp["im_assistant"], *words("assistant", 8),
               sp["im_middle"]])


def padded_size(vision: Mapping, height: int, width: int
                ) -> Tuple[int, int]:
    step = vision["patch_size"] * vision["merge"]
    return -(-height // step) * step, -(-width // step) * step


def image_tokens_of(vision: Mapping, height: int, width: int) -> int:
    step = vision["patch_size"] * vision["merge"]
    hp, wp = padded_size(vision, height, width)
    return (hp // step) * (wp // step)


# ------------------------------------------------------------------ vision


def _rope2d(x: torch.Tensor, gh: int, gw: int, theta: float) -> torch.Tensor:
    """x [..., S, D] over a row-major gh x gw grid: pair j of the dims
    turns by the column (j even) or the row (j odd) times
    theta^(-4 * (j // 2) / D)."""
    D = x.shape[-1]
    j = torch.arange(D // 2, device=x.device)
    f = theta ** (-4.0 * (j // 2).double() / D)
    s = torch.arange(gh * gw, device=x.device)
    pos = torch.where(j % 2 == 0, (s % gw)[:, None], (s // gw)[:, None])
    ang = (pos.double() * f).to(x.dtype)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * ang.cos() - b * ang.sin(),
                        a * ang.sin() + b * ang.cos()], dim=-1).flatten(-2)


def image_features(P: Precision, W: Mapping, cfg: Mapping,
                   images: torch.Tensor) -> torch.Tensor:
    """uint8 [n, H, W, 3] -> image tokens [n, gh/2 * gw/2, hidden]."""
    v = cfg["vision"]
    p, d, heads, eps = (v["patch_size"], v["hidden_size"], v["num_heads"],
                        v["layer_norm_eps"])
    n, H, Wd, _ = images.shape
    hp, wp = padded_size(v, H, Wd)
    x = torch.zeros(n, hp, wp, 3, device=images.device)
    x[:, :H, :Wd] = images.float()
    x = ((x / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
    gh, gw = hp // p, wp // p
    proj = W["vision_tower.patch_embed.proj.weight"]
    patches = F.unfold(x, p, stride=p).transpose(1, 2)     # [n, S, 3*p*p]
    h = linear(P, patches, proj.reshape(d, -1),
               W["vision_tower.patch_embed.proj.bias"])
    table = W["vision_tower.pos_emb"]
    if (gh, gw) != tuple(table.shape[:2]):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw),
                              mode="bicubic")[0].permute(1, 2, 0)
    h = h + table.reshape(gh * gw, d)
    for i in range(v["num_layers"]):
        k = f"vision_tower.blocks.{i}."
        y = layer_norm(h, W[k + "norm0.weight"], W[k + "norm0.bias"], eps)
        qkv = linear(P, y, W[k + "wqkv.weight"], W[k + "wqkv.bias"])
        q, kk, val = qkv.view(n, -1, 3, heads, d // heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        q = _rope2d(q, gh, gw, v["rope_theta"])
        kk = _rope2d(kk, gh, gw, v["rope_theta"])
        s = P.matmul(q, kk.transpose(-1, -2)) / math.sqrt(d // heads)
        o = P.matmul(torch.softmax(s, dim=-1), val)
        del s
        o = o.transpose(1, 2).reshape(n, -1, d)
        h = h + linear(P, o, W[k + "wo.weight"], W[k + "wo.bias"])
        y = layer_norm(h, W[k + "norm1.weight"], W[k + "norm1.bias"], eps)
        y = F.gelu(linear(P, y, W[k + "mlp.fc0.weight"],
                          W[k + "mlp.fc0.bias"]), approximate="tanh")
        h = h + linear(P, y, W[k + "mlp.fc1.weight"], W[k + "mlp.fc1.bias"])
    h = layer_norm(h, W["vision_tower.final_layernorm.weight"],
                   W["vision_tower.final_layernorm.bias"], eps)
    pre = "multi_modal_projector."
    h = layer_norm(h, W[pre + "pre_norm.weight"], W[pre + "pre_norm.bias"],
                   1e-5).view(n, gh // 2, 2, gw // 2, 2, d)
    m = h.permute(0, 1, 3, 2, 4, 5).reshape(n, (gh // 2) * (gw // 2), -1)
    m = F.gelu(linear(P, m, W[pre + "linear_1.weight"],
                      W[pre + "linear_1.bias"]))
    return linear(P, m, W[pre + "linear_2.weight"], W[pre + "linear_2.bias"])


# ------------------------------------------------------------------ decoder


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, ..., D] at positions 0..S-1: de-interleave, rotate_half."""
    S, D = x.shape[0], x.shape[-1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    inv = theta ** (-torch.arange(0, D, 2, device=x.device).double() / D)
    ang = torch.arange(S, device=x.device).double()[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1).to(x.dtype)
    ang = ang.view(S, *[1] * (x.dim() - 2), D)
    half = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * ang.cos() + half * ang.sin()


def _swiglu(P, x, gate, up, down):
    return linear(P, F.silu(linear(P, x, gate)) * linear(P, x, up), down)


def _attention(P: Precision, W: Mapping, k: str, cfg: Mapping,
               x: torch.Tensor) -> torch.Tensor:
    """MLA over one prompt x [S, hidden], causal."""
    S = x.shape[0]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    q = linear(P, x, W[k + "q_proj.weight"]).view(S, H, nope + rope)
    kv_a = linear(P, x, W[k + "kv_a_proj_with_mqa.weight"])
    c = rms_norm(kv_a[:, :r], W[k + "kv_a_layernorm.weight"],
                 cfg["rms_norm_eps"])
    kv = linear(P, c, W[k + "kv_b_proj.weight"]).view(S, H, -1)
    k_pe = _rope(kv_a[:, None, r:], cfg["rope_theta"]).expand(S, H, rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cfg["rope_theta"])],
                  dim=-1).transpose(0, 1)
    key = torch.cat([kv[..., :nope], k_pe], dim=-1).transpose(0, 1)
    s = P.matmul(q, key.transpose(1, 2)) / math.sqrt(nope + rope)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = P.matmul(p, kv[..., nope:].transpose(0, 1))
    return linear(P, o.transpose(0, 1).reshape(S, -1), W[k + "o_proj.weight"])


def _experts(P: Precision, L: Mapping, k: str, cfg: Mapping,
             x: torch.Tensor, given: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse layer over rows x [N, hidden]: each expert over the rows
    routed to it, weighted, plus the shared expert. The experts are the
    top-k of the scores and the bias, or ``given`` [N, k]. -> (output, the
    experts taken, each row's route gap: how far the least of the taken
    experts' scores and bias lies below the k-th best, 0 where the taken
    are the top-k)."""
    w = cfg["moe_intermediate_size"]
    out = _swiglu(P, x, L[k + "shared_experts.gate_proj.weight"],
                  L[k + "shared_experts.up_proj.weight"],
                  L[k + "shared_experts.down_proj.weight"])
    scores = torch.sigmoid(linear(P, x, L[k + "gate.weight"]))
    biased = scores + L[k + "gate.e_score_correction_bias"]
    best = biased.topk(cfg["num_experts_per_tok"], dim=-1)
    top = best.indices if given is None else given
    gap = (best.values[:, -1] - biased.gather(1, top).min(1).values
           ).clamp(min=0)
    weights = scores.gather(1, top)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"]
    gate_up, down = L[k + "experts.gate_up_proj"], L[k + "experts.down_proj"]
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if len(rows):
            y = _swiglu(P, x[rows], gate_up[e, :w], gate_up[e, w:], down[e])
            out.index_add_(0, rows, y * weights[rows, slot, None])
    return out, top, gap


def _layer_keys(W: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {k: W[k] for k in W.keys() if k.startswith(prefix)}


def generate_logprobs(W: Mapping, cfg: Mapping, images: torch.Tensor,
                      questions: Sequence[str],
                      tokens: Sequence[Sequence[int]], P: Precision,
                      routes: Optional[Sequence[Sequence[torch.Tensor]]]
                      = None) -> Tuple[List[torch.Tensor],
                                       List[List[torch.Tensor]],
                                       List[float]]:
    """Pair i's log-probs [len(tokens[i]), vocab] (float32): the full
    forward over its prompt followed by ``tokens[i][:-1]``, read at each
    position that predicts one of ``tokens[i]``; with the experts each
    sparse layer took at each of those positions (``routes[i][j]``
    [positions, k] of the j-th sparse layer: the reference's own top-k, or
    the given ``routes``) and pair i's widest route gap (``_experts``; 0
    without ``routes``)."""
    eps = cfg["rms_norm_eps"]
    feats = image_features(P, W, cfg, images)
    embed = W["language_model.embed_tokens.weight"]
    seqs, hs = [], []
    for i, q in enumerate(questions):
        ids = prompt_ids(cfg, q, feats.shape[1]) \
            + [int(t) for t in tokens[i][:-1]]
        ids_t = torch.tensor(ids, device=images.device)
        h = embed[ids_t].clone()
        slots = ids_t == cfg["media_placeholder_token_id"]
        h[slots] = feats[i, :int(slots.sum())]
        seqs.append((len(ids) - len(tokens[i]) + 1, len(tokens[i])))
        hs.append(h)
    del embed, feats
    lengths = [len(h) for h in hs]
    taken: List[List[torch.Tensor]] = [[] for _ in hs]
    gaps = torch.zeros(len(hs), dtype=torch.float64)
    for layer in range(cfg["num_hidden_layers"]):
        k = f"language_model.layers.{layer}."
        L = _layer_keys(W, k)
        hs = [h + _attention(P, L, k + "self_attn.", cfg, rms_norm(
            h, L[k + "input_layernorm.weight"], eps)) for h in hs]
        # the feed-forward acts on each position alone: all rows at once
        h = torch.cat(hs)
        x = rms_norm(h, L[k + "post_attention_layernorm.weight"], eps)
        if layer < cfg["first_k_dense_replace"]:
            h = h + _swiglu(P, x, L[k + "mlp.gate_proj.weight"],
                            L[k + "mlp.up_proj.weight"],
                            L[k + "mlp.down_proj.weight"])
        else:
            j = layer - cfg["first_k_dense_replace"]
            given = None if routes is None else torch.cat(
                [r[j] for r in routes]).to(x.device)
            y, top, gap = _experts(P, L, k + "mlp.", cfg, x, given)
            h = h + y
            for i, (t, g) in enumerate(zip(top.split(lengths),
                                           gap.split(lengths))):
                taken[i].append(t)
                gaps[i] = max(gaps[i], float(g.max()))
        hs = list(h.split(lengths))
        del L
    norm, head = W["language_model.norm.weight"], W["lm_head.weight"]
    out = []
    for (start, n), h in zip(seqs, hs):
        x = rms_norm(h[start - 1:start - 1 + n], norm, eps)
        out.append(torch.log_softmax(linear(P, x, head), dim=-1))
    return out, taken, gaps.tolist()
