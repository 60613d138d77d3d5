"""Plain reference of ``cross_vitbase_robertabase``: the cross-attention
VQA model of shiv-vignesh/T5-Resnet-VQA (``model/vit_vqa_model.py``,
lines 24-125), in float32, and its training step.

  image_emb = ViT-base/16 embeddings (google/vit-base-patch16-224-in21k:
              16x16/s16 patches, CLS, learned positions; pixels scaled by
              1/255, normalised with mean = std = 0.5)          (frozen)
  text_emb  = RoBERTa-base embeddings (FacebookAI/roberta-base): word +
              position + token type 0 -> LayerNorm -> dropout; positions
              count from pad + 1 over the ids that are not RoBERTa's pad
              (1), which the question tokenizer also uses as EOS
  concat    = [image_emb ; text_emb]; hidden = concat; image = image_emb
  for i in 0..11:
      r      = RoBERTa layer i (post-LN, unmasked attention, erf GELU,
               dropout after both dense outputs)(hidden)
      image  = ViT layer i (pre-LN, eps 1e-12)(image)                (frozen)
      hidden = LayerNorm([r[:, 197:] ; image] + concat)    (one shared LN)
  attention pooler -> classifier -> log_softmax -> mean NLL

``train_steps`` is the training step of the reference config
(``vit_daquar_config.json``): the global-norm clip of the trainable
gradients (divided by the norm + 1e-6), AdamW with amsgrad per LR group
(betas 0.9, 0.999, eps 1e-8, decoupled weight decay) and the linear
warm-up schedule (warm-up = a tenth of the steps, at most
``max_warmup_steps``, the LR of step k (from 1) at (k - 1) / warm-up).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch

from .nn import (
    NO_DROPOUT,
    Dropout,
    Precision,
    attention,
    attention_pool,
    conv2d,
    layer_norm,
    linear,
    merge_heads,
    split_heads,
)
from .cnn import Spec

FROZEN_PREFIXES = ("vit_embeddings.", "vit_encoder_layers.")


def _lin(name: str, out: int, inp: int, std: float) -> Spec:
    return [(f"{name}.weight", (out, inp), "normal", 0.0, std),
            (f"{name}.bias", (out,), "normal", 0.0, 0.02)]


def _ln(name: str, c: int) -> Spec:
    return [(f"{name}.weight", (c,), "normal", 1.0, 0.05),
            (f"{name}.bias", (c,), "normal", 0.0, 0.02)]


def weight_spec(cfg: Mapping) -> Spec:
    """(name, shape, kind, mean, std) of every tensor of the model's
    ``state_dict`` (see ``cnn.weight_spec``). Linears and embeddings draw
    at the published initializer range, 0.02; the classifier wider, so
    that the served answers are not near ties."""
    v, r = cfg["vit"], cfg["roberta"]
    h, A = v["hidden_size"], cfg["answers"]
    n_patches = (v["image_size"] // v["patch_size"]) ** 2
    spec: Spec = [
        ("roberta_embeddings.word_embeddings.weight",
         (r["vocab_size"], h), "normal", 0.0, 0.02),
        ("roberta_embeddings.position_embeddings.weight",
         (r["max_position_embeddings"], h), "normal", 0.0, 0.02),
        ("roberta_embeddings.token_type_embeddings.weight",
         (r["type_vocab_size"], h), "normal", 0.0, 0.02)]
    spec += _ln("roberta_embeddings.LayerNorm", h)
    spec += [("vit_embeddings.cls_token", (1, 1, h), "normal", 0.0, 0.02),
             ("vit_embeddings.position_embeddings", (1, n_patches + 1, h),
              "normal", 0.0, 0.02),
             ("vit_embeddings.patch_embeddings.projection.weight",
              (h, 3, v["patch_size"], v["patch_size"]), "normal", 0.0, 0.02),
             ("vit_embeddings.patch_embeddings.projection.bias", (h,),
              "normal", 0.0, 0.02)]
    spec += _ln("layer_norm", h)
    spec += [("attention_pooler.attention.0.weight", (1, h), "normal", 0.0,
              0.02),
             ("attention_pooler.attention.0.bias", (1,), "normal", 0.0, 0.0)]
    spec += _lin("classification_layer", A, h, 4 * h ** -0.5)
    for i in range(r["num_layers"]):
        p = f"roberta_encoder_layers.{i}."
        for n in ("query", "key", "value"):
            spec += _lin(f"{p}attention.self.{n}", h, h, 0.02)
        spec += _lin(p + "attention.output.dense", h, h, 0.02)
        spec += _ln(p + "attention.output.LayerNorm", h)
        spec += _lin(p + "intermediate.dense", r["intermediate_size"], h,
                     0.02)
        spec += _lin(p + "output.dense", h, r["intermediate_size"], 0.02)
        spec += _ln(p + "output.LayerNorm", h)
    for i in range(v["num_layers"]):
        p = f"vit_encoder_layers.{i}."
        for n in ("query", "key", "value"):
            spec += _lin(f"{p}attention.attention.{n}", h, h, 0.02)
        spec += _lin(p + "attention.output.dense", h, h, 0.02)
        spec += _ln(p + "layernorm_before", h)
        spec += _ln(p + "layernorm_after", h)
        spec += _lin(p + "intermediate.dense", v["mlp_dim"], h, 0.02)
        spec += _lin(p + "output.dense", h, v["mlp_dim"], 0.02)
    return spec


def _dense(P, W, x, name):
    return linear(P, x, W[name + ".weight"], W[name + ".bias"])


def _ln_apply(W, x, name, eps):
    return layer_norm(x, W[name + ".weight"], W[name + ".bias"], eps)


def _self_attention(P, W, x, p, head_dim):
    q, k, v = (split_heads(_dense(P, W, x, p + n), head_dim)
               for n in ("query", "key", "value"))
    return merge_heads(attention(P, q, k, v, head_dim ** -0.5))


def vit_embeddings(P, W, cfg, images):
    v = cfg["vit"]
    dtype = W["vit_embeddings.cls_token"].dtype
    x = (images.to(dtype).div(255.0) - 0.5) / 0.5
    x = conv2d(P, x.permute(0, 3, 1, 2),
               W["vit_embeddings.patch_embeddings.projection.weight"],
               W["vit_embeddings.patch_embeddings.projection.bias"],
               stride=v["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    cls = W["vit_embeddings.cls_token"].expand(x.shape[0], -1, -1)
    return torch.cat([cls, x], 1) + W["vit_embeddings.position_embeddings"]


def vit_layer(P, W, cfg, x, i):
    v = cfg["vit"]
    p, eps = f"vit_encoder_layers.{i}.", v["layer_norm_eps"]
    h = _self_attention(P, W, _ln_apply(W, x, p + "layernorm_before", eps),
                        p + "attention.attention.",
                        v["hidden_size"] // v["num_heads"])
    x = x + _dense(P, W, h, p + "attention.output.dense")
    h = torch.nn.functional.gelu(_dense(
        P, W, _ln_apply(W, x, p + "layernorm_after", eps),
        p + "intermediate.dense"))
    return x + _dense(P, W, h, p + "output.dense")


def roberta_embeddings(W, cfg, ids, drop: Dropout):
    r = cfg["roberta"]
    pad = r["pad_token_id"]
    keep = (ids != pad).long()
    positions = torch.cumsum(keep, dim=1) * keep + pad
    x = (W["roberta_embeddings.word_embeddings.weight"][ids]
         + W["roberta_embeddings.token_type_embeddings.weight"][0]
         + W["roberta_embeddings.position_embeddings.weight"][positions])
    # the program's LayerNorm runs in float32 under autocast
    return drop(_ln_apply(W, x, "roberta_embeddings.LayerNorm",
                          r["layer_norm_eps"]), torch.float32)


def roberta_layer(P, W, cfg, x, i, drop: Dropout, dtype):
    r = cfg["roberta"]
    p, eps = f"roberta_encoder_layers.{i}.", r["layer_norm_eps"]
    h = _self_attention(P, W, x, p + "attention.self.",
                        r["hidden_size"] // r["num_heads"])
    h = drop(_dense(P, W, h, p + "attention.output.dense"), dtype)
    x = _ln_apply(W, x + h, p + "attention.output.LayerNorm", eps)
    h = torch.nn.functional.gelu(_dense(P, W, x, p + "intermediate.dense"))
    h = drop(_dense(P, W, h, p + "output.dense"), dtype)
    return _ln_apply(W, x + h, p + "output.LayerNorm", eps)


def forward(W: Mapping[str, torch.Tensor], cfg: Mapping, images, ids,
            P: Precision, drop: Dropout = NO_DROPOUT,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC images [B, 224, 224, 3] and question ids [B, L] ->
    float32 log-probs [B, answers]. ``drop`` draws the dropout masks; the
    dense outputs it drops are ``dtype`` in the program (its compute
    dtype), the embeddings' LayerNorm output float32."""
    with torch.no_grad():
        image_emb = vit_embeddings(P, W, cfg, images)
    text_emb = roberta_embeddings(W, cfg, ids, drop)
    n_img = image_emb.shape[1]
    concat = torch.cat([image_emb, text_emb], dim=1)
    hidden, image = concat, image_emb
    layers = min(cfg["vit"]["num_layers"], cfg["roberta"]["num_layers"])
    for i in range(layers):
        r = roberta_layer(P, W, cfg, hidden, i, drop, dtype)
        with torch.no_grad():
            image = vit_layer(P, W, cfg, image, i)
        hidden = _ln_apply(W, torch.cat([r[:, n_img:], image], 1) + concat,
                           "layer_norm", 1e-5)
    pooled = attention_pool(P, W, hidden, "attention_pooler.")
    return torch.log_softmax(_dense(P, W, pooled, "classification_layer"),
                             dim=-1)


def trainable(name: str) -> bool:
    return not name.startswith(FROZEN_PREFIXES)


def lr_group(name: str) -> str:
    """The reference trainer's LR group of a trainable weight."""
    top = name.split(".")[0]
    if top == "roberta_embeddings":
        return "lm_encoder_lr"
    if top in ("layer_norm", "attention_pooler"):
        return "fusion_lr"
    if top == "classification_layer":
        return "classifier_lr"
    return "default_lr"


def warmup_steps(train_config: Mapping, total: int) -> int:
    sched = train_config["lr_scheduler_kwargs"]
    warm = sched["num_warmup_steps"]
    warm = total // 10 if warm == -1 else warm
    return min(warm, sched["max_warmup_steps"])


def lr_factor(step: int, warmup: int, total: int) -> float:
    """The schedule's factor for the optimizer step ``step`` (from 0)."""
    if step < warmup:
        return step / max(1.0, warmup)
    return max(0.0, (total - step) / max(1.0, total - warmup))


def _rng_state(device) -> torch.Tensor:
    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(device, state: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def train_steps(W0: Mapping[str, torch.Tensor], cfg: Mapping,
                batches: Sequence[Mapping[str, torch.Tensor]],
                total_steps: int, P: Precision,
                rng_state: Optional[torch.Tensor], dtype: torch.dtype,
                rows: Optional[int] = None) -> Dict[str, object]:
    """The reference's first ``len(batches)`` training steps from the
    weights ``W0``, each batch ``{"images", "ids", "labels"}``, with
    RoBERTa's dropout masks drawn from the generator of the weights'
    device at ``rng_state``; ``dtype`` is the program's compute dtype.
    ``rows``: the rows of a batch that one pass of forward and backward
    takes (all by default); the passes' gradients are summed, and each
    pass draws the whole batch's masks from the step's generator state
    and applies its own rows of them. Returns the steps' losses, the
    clipped gradient of step 1 by weight and the change of every
    trainable weight over the steps."""
    tc = cfg["train_config"]
    kw = tc["optimizer_kwargs"]
    wd = kw["kwargs"]["weight_decay"]
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    clip = tc["trainer_kwargs"]["gradient_clipping"]
    warmup = warmup_steps(tc, total_steps)
    W = {k: v.detach().clone().to(P.dtype) for k, v in W0.items()}
    names = [k for k in W if trainable(k)]
    for k in names:
        W[k].requires_grad_(True)
    state = {k: (torch.zeros_like(W[k]), torch.zeros_like(W[k]),
                 torch.zeros_like(W[k])) for k in names}
    device = next(iter(W.values())).device
    if rng_state is not None:
        _set_rng_state(device, rng_state)
    drop = Dropout(cfg["roberta"]["dropout_rate"])
    losses: List[float] = []
    first_grad: Dict[str, torch.Tensor] = {}
    for step, batch in enumerate(batches):
        B = len(batch["labels"])
        step_rng = _rng_state(device)
        grads, loss = None, 0.0
        for a in range(0, B, rows or B):
            b = min(B, a + (rows or B))
            if (a, b) != (0, B):
                _set_rng_state(device, step_rng)
            log_probs = forward(W, cfg, batch["images"][a:b],
                                batch["ids"][a:b], P,
                                drop if (a, b) == (0, B)
                                else drop.of_rows(slice(a, b), B), dtype)
            part = -log_probs.gather(
                -1, batch["labels"][a:b, None]).sum() / B
            g = torch.autograd.grad(part, [W[k] for k in names])
            grads = list(g) if grads is None else [
                x.add_(y) for x, y in zip(grads, g)]
            loss += float(part.detach())
            del log_probs, part, g
        losses.append(loss)
        with torch.no_grad():
            total = torch.sqrt(sum(g.double().square().sum() for g in grads))
            coef = min(1.0, clip / (float(total) + 1e-6))
            grads = [g * coef for g in grads]
            if step == 0:
                first_grad = {k: g.clone() for k, g in zip(names, grads)}
            lr_f = lr_factor(step, warmup, total_steps)
            t = step + 1
            for k, g in zip(names, grads):
                lr = kw[lr_group(k)] * lr_f
                m, v, vmax = state[k]
                W[k].mul_(1.0 - lr * wd)
                m.lerp_(g, 1.0 - beta1)
                v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
                torch.maximum(vmax, v, out=vmax)
                denom = (vmax.sqrt() / (1.0 - beta2 ** t) ** 0.5).add_(eps)
                W[k].addcdiv_(m, denom, value=-lr / (1.0 - beta1 ** t))
        del grads
    change = {k: (W[k].detach() - W0[k].to(P.dtype)) for k in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def serve_logprobs(W, cfg, images, questions, answers, P: Precision):
    """Log-probs of (image, question) pairs as served (eval mode: no
    dropout), the question ids worked out again from the texts."""
    from .inputs import question_ids

    ids, _ = question_ids(questions, cfg["question_len"], answers)
    return forward(W, cfg, images, torch.from_numpy(ids).to(images.device),
                   P)
