"""Plain reference of ``cnn_resnet50_t5base``: the CNN-family VQA model of
shiv-vignesh/T5-Resnet-VQA (``model/resnet_vqa_model.py``), in float32.

  images (uint8 NHWC, scaled by 1/255, not normalised)
  -> ResNet-50 v1.5 (arXiv:1512.03385; stride on the 3x3), BatchNorm in
     eval mode from its statistics, C5 [B, 2048, h, w]
  -> ConvTranspose2d(2048 -> 768, k3, s1, p1), tokens in row-major h, w
  -> T5 encoder (google-t5/t5-base) over the question ids with its mask:
     RMSNorm pre-norm blocks, unscaled attention with block 0's relative
     position bias, ReLU feed-forward
  -> 3 SGA blocks (H=8, D=96): x = LN(x + MHA(x, x, x)),
     x = LN(x + MHA(q=x, k=v=y)), x = LN(x + FFN(x)); every block reads
     the text states as x and the previous block's output as y, the first
     y being the vision tokens
  -> attention pooler -> classifier -> log_softmax.

Serving only (eval mode, no dropout). Weight names are the published
checkpoints' (torchvision, HF T5, the reference repo's), which
``weight_spec`` lists with the random distribution each is drawn from.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F

from .nn import (
    Precision,
    attention,
    attention_pool,
    conv2d,
    conv_transpose2d,
    layer_norm,
    linear,
    merge_heads,
    relative_position_bucket,
    rms_norm,
    split_heads,
)

Spec = List[Tuple[str, Tuple[int, ...], str, float, float]]


def _bn_spec(name: str, c: int, gamma: float) -> Spec:
    """A frozen BatchNorm: weight near ``gamma``, small bias and mean, a
    variance near 1 (drawn as exp(0.2 n))."""
    return [(f"{name}.weight", (c,), "normal", gamma, 0.1 * gamma),
            (f"{name}.bias", (c,), "normal", 0.0, 0.05),
            (f"{name}.running_mean", (c,), "normal", 0.0, 0.05),
            (f"{name}.running_var", (c,), "lognormal", 1.0, 0.2),
            (f"{name}.num_batches_tracked", (), "count", 0.0, 0.0)]


def _conv_spec(name: str, cout: int, cin: int, k: int) -> Spec:
    return [(name, (cout, cin, k, k), "normal", 0.0, (2.0 / (cin * k * k))
             ** 0.5)]


def weight_spec(cfg: Mapping) -> Spec:
    """(name, shape, kind, mean, std) of every tensor of the model's
    ``state_dict``, in its order. ``kind``: ``normal`` (mean + std n),
    ``lognormal`` (mean exp(std n)) or ``count`` (int64 0)."""
    r, t, s = cfg["resnet"], cfg["t5"], cfg["sga"]
    hidden, A = cfg["hidden_size"], cfg["answers"]
    spec: Spec = _conv_spec("vision_model.conv1.weight", r["stem_channels"],
                            3, 7)
    spec += _bn_spec("vision_model.bn1", r["stem_channels"], 1.0)
    cin = r["stem_channels"]
    for stage, (depth, width) in enumerate(zip(r["depths"], r["widths"])):
        cout = width * r["expansion"]
        for b in range(depth):
            p = f"vision_model.layer{stage + 1}.{b}."
            c_in = cin if b == 0 else cout
            spec += _conv_spec(p + "conv1.weight", width, c_in, 1)
            spec += _bn_spec(p + "bn1", width, 1.0)
            spec += _conv_spec(p + "conv2.weight", width, width, 3)
            spec += _bn_spec(p + "bn2", width, 1.0)
            spec += _conv_spec(p + "conv3.weight", cout, width, 1)
            # a small last gain keeps the residual stream's scale over 16
            # blocks, as a trained network's does
            spec += _bn_spec(p + "bn3", cout, 0.2)
            if b == 0:
                spec += _conv_spec(p + "downsample.0.weight", cout, c_in, 1)
                spec += _bn_spec(p + "downsample.1", cout, 1.0)
        cin = cout
    spec += [("vision_model.fc.weight", (1000, cin), "normal", 0.0, 0.02),
             ("vision_model.fc.bias", (1000,), "normal", 0.0, 0.0)]
    # the reference holds both projections and uses the 2048-channel one
    for name, c in (("downscale_layer", cin), ("upscale_layer", 512)):
        spec += [(f"{name}.weight", (c, hidden, 3, 3), "normal", 0.0,
                  (c * 9) ** -0.5),
                 (f"{name}.bias", (hidden,), "normal", 0.0, 0.02)]
    d, kv, H = t["d_model"], t["d_kv"], t["num_heads"]
    spec.append(("lang_model.embed_tokens.weight", (t["vocab_size"], d),
                 "normal", 0.0, 1.0))
    for i in range(t["num_layers"]):
        p = f"lang_model.block.{i}.layer."
        spec += [(p + "0.SelfAttention.q.weight", (H * kv, d), "normal", 0.0,
                  (d * kv) ** -0.5),
                 (p + "0.SelfAttention.k.weight", (H * kv, d), "normal", 0.0,
                  d ** -0.5),
                 (p + "0.SelfAttention.v.weight", (H * kv, d), "normal", 0.0,
                  d ** -0.5),
                 (p + "0.SelfAttention.o.weight", (d, H * kv), "normal", 0.0,
                  (H * kv) ** -0.5)]
        if i == 0:
            spec.append((p + "0.SelfAttention.relative_attention_bias.weight",
                         (t["relative_attention_num_buckets"], H), "normal",
                         0.0, d ** -0.5))
        spec += [(p + "0.layer_norm.weight", (d,), "normal", 1.0, 0.05),
                 (p + "1.DenseReluDense.wi.weight", (t["d_ff"], d), "normal",
                  0.0, d ** -0.5),
                 (p + "1.DenseReluDense.wo.weight", (d, t["d_ff"]), "normal",
                  0.0, t["d_ff"] ** -0.5),
                 (p + "1.layer_norm.weight", (d,), "normal", 1.0, 0.05)]
    spec.append(("lang_model.final_layer_norm.weight", (d,), "normal", 1.0,
                 0.05))
    lin = hidden ** -0.5
    for b in range(s["blocks"]):
        p = f"sga_modules.{b}."
        for att in ("mhatt1", "mhatt2"):
            for proj in ("linear_v", "linear_k", "linear_q", "linear_merge"):
                spec += [(f"{p}{att}.{proj}.weight", (hidden, hidden),
                          "normal", 0.0, lin),
                         (f"{p}{att}.{proj}.bias", (hidden,), "normal", 0.0,
                          0.02)]
        spec += [(p + "ffn.mlp.fc1.weight", (s["ff_size"], hidden), "normal",
                  0.0, lin),
                 (p + "ffn.mlp.fc1.bias", (s["ff_size"],), "normal", 0.0,
                  0.02),
                 (p + "ffn.mlp.fc2.weight", (hidden, s["ff_size"]), "normal",
                  0.0, s["ff_size"] ** -0.5),
                 (p + "ffn.mlp.fc2.bias", (hidden,), "normal", 0.0, 0.02)]
        for n in ("norm1", "norm2", "norm3"):
            spec += [(f"{p}{n}.norm.weight", (hidden,), "normal", 1.0, 0.05),
                     (f"{p}{n}.norm.bias", (hidden,), "normal", 0.0, 0.02)]
    spec += [("attention_pooler.attention.0.weight", (1, hidden), "normal",
              0.0, lin),
             ("attention_pooler.attention.0.bias", (1,), "normal", 0.0, 0.0),
             ("classification_layer.weight", (A, hidden), "normal", 0.0,
              3 * lin),
             ("classification_layer.bias", (A,), "normal", 0.0, 0.02)]
    return spec


def _bn(W, x, name, eps=1e-5):
    scale = W[name + ".weight"] * torch.rsqrt(W[name + ".running_var"] + eps)
    shift = W[name + ".bias"] - W[name + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def resnet_c5(P: Precision, W, cfg, x):
    """NCHW float images -> C5."""
    r = cfg["resnet"]
    h = torch.relu(_bn(W, conv2d(P, x, W["vision_model.conv1.weight"],
                                 stride=2, padding=3), "vision_model.bn1"))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for stage, depth in enumerate(r["depths"]):
        for b in range(depth):
            p = f"vision_model.layer{stage + 1}.{b}."
            stride = 2 if stage > 0 and b == 0 else 1
            out = torch.relu(_bn(W, conv2d(P, h, W[p + "conv1.weight"]),
                                 p + "bn1"))
            out = torch.relu(_bn(W, conv2d(P, out, W[p + "conv2.weight"],
                                           stride=stride, padding=1),
                                 p + "bn2"))
            out = _bn(W, conv2d(P, out, W[p + "conv3.weight"]), p + "bn3")
            if b == 0:
                h = _bn(W, conv2d(P, h, W[p + "downsample.0.weight"],
                                  stride=stride), p + "downsample.1")
            h = torch.relu(out + h)
    return h


def t5_encoder(P: Precision, W, cfg, ids, mask):
    t = cfg["t5"]
    eps, kv = t["layer_norm_epsilon"], t["d_kv"]
    x = W["lang_model.embed_tokens.weight"][ids]
    S = ids.shape[1]
    pos = torch.arange(S, device=ids.device)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], t["relative_attention_num_buckets"],
        t["relative_attention_max_distance"])
    table = W["lang_model.block.0.layer.0.SelfAttention."
              "relative_attention_bias.weight"]
    bias = table[buckets].permute(2, 0, 1)[None]
    bias = bias + (1.0 - mask.float())[:, None, None, :] * -1e9
    for i in range(t["num_layers"]):
        p = f"lang_model.block.{i}.layer."
        h = rms_norm(x, W[p + "0.layer_norm.weight"], eps)
        q, k, v = (split_heads(linear(P, h, W[f"{p}0.SelfAttention.{n}"
                                               ".weight"]), kv)
                   for n in "qkv")
        ctx = merge_heads(attention(P, q, k, v, 1.0, bias))
        x = x + linear(P, ctx, W[p + "0.SelfAttention.o.weight"])
        h = rms_norm(x, W[p + "1.layer_norm.weight"], eps)
        h = torch.relu(linear(P, h, W[p + "1.DenseReluDense.wi.weight"]))
        x = x + linear(P, h, W[p + "1.DenseReluDense.wo.weight"])
    return rms_norm(x, W["lang_model.final_layer_norm.weight"], eps)


def _mha(P, W, p, v, k, q, head_dim):
    def proj(x, name):
        return linear(P, x, W[f"{p}{name}.weight"], W[f"{p}{name}.bias"])
    ctx = attention(P, split_heads(proj(q, "linear_q"), head_dim),
                    split_heads(proj(k, "linear_k"), head_dim),
                    split_heads(proj(v, "linear_v"), head_dim),
                    head_dim ** -0.5)
    return proj(merge_heads(ctx), "linear_merge")


def sga_stack(P: Precision, W, cfg, text, vision):
    hidden, s = cfg["hidden_size"], cfg["sga"]
    D = hidden // s["num_heads"]

    def ln(x, name):
        return layer_norm(x, W[name + ".norm.weight"], W[name + ".norm.bias"],
                          1e-5)

    y = vision
    for b in range(s["blocks"]):
        p = f"sga_modules.{b}."
        x = text
        x = ln(x + _mha(P, W, p + "mhatt1.", x, x, x, D), p + "norm1")
        x = ln(x + _mha(P, W, p + "mhatt2.", y, y, x, D), p + "norm2")
        h = torch.relu(linear(P, x, W[p + "ffn.mlp.fc1.weight"],
                              W[p + "ffn.mlp.fc1.bias"]))
        h = linear(P, h, W[p + "ffn.mlp.fc2.weight"], W[p + "ffn.mlp.fc2.bias"])
        y = ln(x + h, p + "norm3")
    return y


def forward(W: Mapping[str, torch.Tensor], cfg: Mapping, images, ids, mask,
            P: Precision) -> torch.Tensor:
    """uint8 NHWC images [B, H, W, 3], question ids and mask [B, L] ->
    float32 log-probs [B, answers]."""
    x = images.float().div(255.0).permute(0, 3, 1, 2)
    c5 = resnet_c5(P, W, cfg, x)
    v = conv_transpose2d(P, c5, W["downscale_layer.weight"],
                         W["downscale_layer.bias"], padding=1)
    B, C = v.shape[:2]
    vision = v.permute(0, 2, 3, 1).reshape(B, -1, C)
    text = t5_encoder(P, W, cfg, ids, mask)
    fused = sga_stack(P, W, cfg, text, vision)
    pooled = attention_pool(P, W, fused, "attention_pooler.")
    logits = linear(P, pooled, W["classification_layer.weight"],
                    W["classification_layer.bias"])
    return torch.log_softmax(logits, dim=-1)



def serve_logprobs(W, cfg, images, questions, answers, P: Precision):
    """Log-probs of (image, question) pairs as served: the question ids
    worked out again from the texts (``inputs.question_ids``)."""
    from .inputs import question_ids

    ids, mask = question_ids(questions, cfg["question_len"], answers)
    ids, mask = (torch.from_numpy(a).to(images.device) for a in (ids, mask))
    return forward(W, cfg, images, ids, mask, P)
