"""Weight bridge: JAX param trees (nested dicts of numpy arrays) -> the
port's ``state_dict``, which is the reference's own layout.

A copy of the numpy-only exporters of
``t5_resnet_vqa_tpu/utils/torch_export.py`` that the four family exporters
(``export_resnet_vqa_checkpoint``, ``export_faster_rcnn_vqa_checkpoint``,
``export_vit_vqa_checkpoint``, ``export_cross_attention_vqa_checkpoint``)
need; the port keeps its own copy so that it never imports the JAX
package.
Conventions:

  * flax Dense kernel [in, out]  -> Linear weight [out, in]
  * flax Conv kernel HWIO        -> Conv2d weight OIHW
  * equivalent SAME-conv kernel  -> ConvTranspose2d(k, s1, p1) weight
                                    [I, O, kh, kw], spatial flip undone
  * folded FrozenBatchNorm (scale, bias) -> BatchNorm with weight=scale,
    bias=bias, running_mean=0, running_var=1-eps (eval-mode identical)
  * modules the reference holds but never uses (the unused projection twin,
    the backbone's ``fc``) are zeros, so strict loading succeeds;
  * the ViT family's one tied T5 table is written under all four of HF's
    tied keys, as one tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _put(out: Dict[str, Any], prefix: str, name: str, tensor) -> None:
    out[f"{prefix}.{name}" if prefix else name] = tensor


def export_linear(out, tree: Mapping[str, Any], prefix: str) -> None:
    _put(out, prefix, "weight", _t(np.asarray(tree["kernel"]).T))
    if "bias" in tree:
        _put(out, prefix, "bias", _t(tree["bias"]))


def export_layernorm(out, tree, prefix: str) -> None:
    _put(out, prefix, "weight", _t(tree["scale"]))
    _put(out, prefix, "bias", _t(tree["bias"]))


def export_conv2d(out, tree, prefix: str) -> None:
    _put(out, prefix, "weight",
         _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)))
    if "bias" in tree:
        _put(out, prefix, "bias", _t(tree["bias"]))


def export_conv_as_conv_transpose2d(out, tree, prefix: str) -> None:
    w = np.asarray(tree["kernel"]).transpose(2, 3, 0, 1)   # -> [I, O, kh, kw]
    _put(out, prefix, "weight", _t(w[:, :, ::-1, ::-1]))
    if "bias" in tree:
        _put(out, prefix, "bias", _t(tree["bias"]))


def export_frozen_batchnorm(out, tree, prefix: str, eps: float = 1e-5,
                            tracked: bool = True) -> None:
    scale = np.asarray(tree["scale"])
    _put(out, prefix, "weight", _t(scale))
    _put(out, prefix, "bias", _t(tree["bias"]))
    _put(out, prefix, "running_mean", torch.zeros(scale.shape[0]))
    _put(out, prefix, "running_var",
         torch.full((scale.shape[0],), 1.0 - eps))
    if tracked:       # FrozenBatchNorm2d state dicts carry no tracker
        _put(out, prefix, "num_batches_tracked",
             torch.zeros((), dtype=torch.int64))


def export_embedding(out, tree, prefix: str) -> None:
    _put(out, prefix, "weight", _t(tree["embedding"]))


def export_rmsnorm(out, tree, prefix: str) -> None:
    _put(out, prefix, "weight", _t(tree["weight"]))


def export_mhatt(out, tree, prefix: str) -> None:
    for m in ("linear_v", "linear_k", "linear_q", "linear_merge"):
        export_linear(out, tree[m], f"{prefix}.{m}")


def export_sga_stack(out, tree, num_blocks: int,
                     prefix: str = "sga_modules") -> None:
    for i in range(num_blocks):
        b = tree[f"sga_{i}"]
        p = f"{prefix}.{i}"
        export_mhatt(out, b["mhatt1"], f"{p}.mhatt1")
        export_mhatt(out, b["mhatt2"], f"{p}.mhatt2")
        export_linear(out, b["ffn"]["mlp"]["fc1"], f"{p}.ffn.mlp.fc1")
        export_linear(out, b["ffn"]["mlp"]["fc2"], f"{p}.ffn.mlp.fc2")
        for n in ("norm1", "norm2", "norm3"):
            export_layernorm(out, b[n], f"{p}.{n}.norm")


def export_attention_pooler(out, tree,
                            prefix: str = "attention_pooler") -> None:
    export_linear(out, tree["attention"], f"{prefix}.attention.0")


_RESNET_DEPTHS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
}
_RESNET_BOTTLENECK = {"resnet18": False, "resnet34": False, "resnet50": True}
_RESNET_FEATURES = {"resnet18": 512, "resnet34": 512, "resnet50": 2048}


def export_resnet_torchvision(out, tree, variant: str, prefix: str = "",
                              tracked: bool = True) -> None:
    p = f"{prefix}." if prefix else ""
    export_conv2d(out, tree["conv1"], f"{p}conv1")
    export_frozen_batchnorm(out, tree["bn1"], f"{p}bn1", tracked=tracked)
    n_convs = 3 if _RESNET_BOTTLENECK[variant] else 2
    for s, depth in enumerate(_RESNET_DEPTHS[variant], start=1):
        for b in range(depth):
            blk = tree[f"layer{s}_block{b}"]
            bp = f"{p}layer{s}.{b}"
            for c in range(1, n_convs + 1):
                export_conv2d(out, blk[f"conv{c}"], f"{bp}.conv{c}")
                export_frozen_batchnorm(out, blk[f"bn{c}"], f"{bp}.bn{c}",
                                        tracked=tracked)
            if "downsample_conv" in blk:
                export_conv2d(out, blk["downsample_conv"],
                              f"{bp}.downsample.0")
                export_frozen_batchnorm(out, blk["downsample_bn"],
                                        f"{bp}.downsample.1",
                                        tracked=tracked)


def _export_t5_attention(out, tree, prefix: str) -> None:
    for m in ("q", "k", "v", "o"):
        export_linear(out, tree[m], f"{prefix}.{m}")
    if "relative_attention_bias" in tree:
        export_embedding(out, tree["relative_attention_bias"],
                         f"{prefix}.relative_attention_bias")


def export_t5_encoder(out, tree, num_layers: int, prefix: str = "encoder",
                      shared_key: Optional[str] = "shared.weight") -> None:
    if shared_key is not None:       # None: the caller writes the tied table
        out[shared_key] = _t(tree["shared"]["embedding"])
    export_rmsnorm(out, tree["final_layer_norm"],
                   f"{prefix}.final_layer_norm")
    for i in range(num_layers):
        blk = tree[f"block_{i}"]
        b = f"{prefix}.block.{i}"
        _export_t5_attention(out, blk["self_attn"],
                             f"{b}.layer.0.SelfAttention")
        export_rmsnorm(out, blk["self_attn_layer_norm"],
                       f"{b}.layer.0.layer_norm")
        export_linear(out, blk["ff"]["wi"], f"{b}.layer.1.DenseReluDense.wi")
        export_linear(out, blk["ff"]["wo"], f"{b}.layer.1.DenseReluDense.wo")
        export_rmsnorm(out, blk["ff_layer_norm"], f"{b}.layer.1.layer_norm")


def export_t5_decoder(out, tree, num_layers: int, prefix: str = "decoder",
                      shared_key: Optional[str] = "shared.weight") -> None:
    if shared_key is not None:       # None: the caller writes the tied table
        out[shared_key] = _t(tree["shared"]["embedding"])
    export_rmsnorm(out, tree["final_layer_norm"],
                   f"{prefix}.final_layer_norm")
    for i in range(num_layers):
        blk = tree[f"block_{i}"]
        b = f"{prefix}.block.{i}"
        _export_t5_attention(out, blk["self_attn"],
                             f"{b}.layer.0.SelfAttention")
        export_rmsnorm(out, blk["self_attn_layer_norm"],
                       f"{b}.layer.0.layer_norm")
        _export_t5_attention(out, blk["cross_attn"],
                             f"{b}.layer.1.EncDecAttention")
        export_rmsnorm(out, blk["cross_attn_layer_norm"],
                       f"{b}.layer.1.layer_norm")
        export_linear(out, blk["ff"]["wi"], f"{b}.layer.2.DenseReluDense.wi")
        export_linear(out, blk["ff"]["wo"], f"{b}.layer.2.DenseReluDense.wo")
        export_rmsnorm(out, blk["ff_layer_norm"], f"{b}.layer.2.layer_norm")


def export_vit_embeddings(out, tree, prefix: str = "embeddings") -> None:
    _put(out, prefix, "cls_token", _t(tree["cls_token"]))
    _put(out, prefix, "position_embeddings",
         _t(tree["position_embeddings"]))
    export_conv2d(out, tree["patch_embeddings"],
                  f"{prefix}.patch_embeddings.projection")


def export_vit_layer(out, tree, prefix: str) -> None:
    att = tree["attention"]
    export_linear(out, att["query"], f"{prefix}.attention.attention.query")
    export_linear(out, att["key"], f"{prefix}.attention.attention.key")
    export_linear(out, att["value"], f"{prefix}.attention.attention.value")
    export_linear(out, att["out"], f"{prefix}.attention.output.dense")
    export_layernorm(out, tree["layernorm_before"],
                     f"{prefix}.layernorm_before")
    export_layernorm(out, tree["layernorm_after"],
                     f"{prefix}.layernorm_after")
    export_linear(out, tree["intermediate"], f"{prefix}.intermediate.dense")
    export_linear(out, tree["output"], f"{prefix}.output.dense")


def export_vit(out, tree, num_layers: int, prefix: str = "") -> None:
    p = f"{prefix}." if prefix else ""
    export_vit_embeddings(out, tree, f"{p}embeddings")
    export_layernorm(out, tree["layernorm"], f"{p}layernorm")
    export_linear(out, tree["pooler"], f"{p}pooler.dense")
    for i in range(num_layers):
        export_vit_layer(out, tree[f"layer_{i}"], f"{p}encoder.layer.{i}")


def export_roberta_embeddings(out, tree,
                              prefix: str = "embeddings") -> None:
    export_embedding(out, tree["word_embeddings"],
                     f"{prefix}.word_embeddings")
    export_embedding(out, tree["position_embeddings"],
                     f"{prefix}.position_embeddings")
    export_embedding(out, tree["token_type_embeddings"],
                     f"{prefix}.token_type_embeddings")
    export_layernorm(out, tree["LayerNorm"], f"{prefix}.LayerNorm")


def export_roberta_layer(out, tree, prefix: str) -> None:
    export_linear(out, tree["query"], f"{prefix}.attention.self.query")
    export_linear(out, tree["key"], f"{prefix}.attention.self.key")
    export_linear(out, tree["value"], f"{prefix}.attention.self.value")
    export_linear(out, tree["attention_output"],
                  f"{prefix}.attention.output.dense")
    export_layernorm(out, tree["attention_LayerNorm"],
                     f"{prefix}.attention.output.LayerNorm")
    export_linear(out, tree["intermediate"], f"{prefix}.intermediate.dense")
    export_linear(out, tree["output"], f"{prefix}.output.dense")
    export_layernorm(out, tree["output_LayerNorm"],
                     f"{prefix}.output.LayerNorm")


def export_fpn(out, tree, prefix: str = "fpn", num_levels: int = 4) -> None:
    for i in range(num_levels):
        export_conv2d(out, tree[f"inner_{i}"], f"{prefix}.inner_blocks.{i}")
        export_conv2d(out, tree[f"layer_{i}"], f"{prefix}.layer_blocks.{i}")


def state_dict_from_jax(params: Mapping[str, Any], variant: str,
                        num_attention_blocks: int = 3,
                        num_t5_layers: int = 12) -> Dict[str, torch.Tensor]:
    """ResnetVQAModel params (JAX layout) -> the port's ``state_dict``
    (``ResnetVQAModel.load_state_dict(..., strict=True)`` takes it)."""
    out: Dict[str, Any] = {}
    export_resnet_torchvision(out, params["vision_model"], variant,
                              "vision_model")
    feats = _RESNET_FEATURES[variant]
    out["vision_model.fc.weight"] = torch.zeros(1000, feats)
    out["vision_model.fc.bias"] = torch.zeros(1000)
    used = "downscale_layer" if variant == "resnet50" else "upscale_layer"
    export_conv_as_conv_transpose2d(out, params[used]["conv"], used)
    unused = "upscale_layer" if used == "downscale_layer" else "downscale_layer"
    cin = 512 if unused == "upscale_layer" else 2048
    out[f"{unused}.weight"] = torch.zeros(cin, 768, 3, 3)
    out[f"{unused}.bias"] = torch.zeros(768)
    export_t5_encoder(out, params["lang_model"], num_t5_layers,
                      prefix="lang_model",
                      shared_key="lang_model.embed_tokens.weight")
    export_sga_stack(out, params["sga_modules"], num_attention_blocks)
    export_attention_pooler(out, params["attention_pooler"])
    export_linear(out, params["classification_layer"], "classification_layer")
    return out


def vit_state_dict_from_jax(params: Mapping[str, Any],
                            num_vit_layers: int = 12,
                            num_t5_layers: int = 12
                            ) -> Dict[str, torch.Tensor]:
    """VitVQAModel params (JAX layout) -> the port's ``state_dict``
    (``VitVQAModel.load_state_dict(..., strict=True)`` takes it): the
    counterpart of ``export_vit_vqa_checkpoint``."""
    out: Dict[str, Any] = {}
    export_vit(out, params["vision_model"], num_vit_layers,
               prefix="vision_model")
    export_t5_encoder(out, params["lang_encoder"], num_t5_layers,
                      prefix="lang_model.encoder", shared_key=None)
    export_t5_decoder(out, params["lang_decoder"], num_t5_layers,
                      prefix="lang_model.decoder", shared_key=None)
    shared = _t(params["shared"]["embedding"])
    for key in ("shared", "encoder.embed_tokens", "decoder.embed_tokens",
                "lm_head"):
        out[f"lang_model.{key}.weight"] = shared
    export_linear(out, params["fusing_layer"], "fusing_layer.0")
    export_linear(out, params["classification_layer"], "classification_layer")
    return out


def faster_rcnn_state_dict_from_jax(params: Mapping[str, Any],
                                    num_attention_blocks: int = 3,
                                    num_t5_layers: int = 12
                                    ) -> Dict[str, torch.Tensor]:
    """FasterRcnnVQAModel params (JAX layout) -> the port's ``state_dict``:
    the counterpart of ``export_faster_rcnn_vqa_checkpoint`` (the body
    without trackers or ``fc``, then the FPN, under ``vision_model``)."""
    out: Dict[str, Any] = {}
    export_resnet_torchvision(out, params["vision_model"], "resnet50",
                              "vision_model.body", tracked=False)
    export_fpn(out, params["fpn"], prefix="vision_model.fpn")
    export_conv_as_conv_transpose2d(out, params["upscale_layer"]["conv"],
                                    "upscale_layer")
    export_t5_encoder(out, params["lang_model"], num_t5_layers,
                      prefix="lang_model",
                      shared_key="lang_model.embed_tokens.weight")
    export_sga_stack(out, params["sga_modules"], num_attention_blocks)
    export_attention_pooler(out, params["attention_pooler"])
    export_linear(out, params["classification_layer"], "classification_layer")
    return out


def cross_attention_state_dict_from_jax(params: Mapping[str, Any],
                                        num_layers: int = 12
                                        ) -> Dict[str, torch.Tensor]:
    """CrossAttentionVitVQAModel params (JAX layout) -> the port's
    ``state_dict``: the counterpart of
    ``export_cross_attention_vqa_checkpoint``."""
    out: Dict[str, Any] = {}
    export_roberta_embeddings(out, params["roberta_embeddings"],
                              "roberta_embeddings")
    export_vit_embeddings(out, params["vit_embeddings"], "vit_embeddings")
    export_layernorm(out, params["layer_norm"], "layer_norm")
    export_attention_pooler(out, params["attention_pooler"])
    export_linear(out, params["classification_layer"], "classification_layer")
    for i in range(num_layers):
        export_roberta_layer(out, params[f"roberta_layer_{i}"],
                             f"roberta_encoder_layers.{i}")
        export_vit_layer(out, params[f"vit_layer_{i}"],
                         f"vit_encoder_layers.{i}")
    return out
