"""Heatmaps and the test-set WUPS evaluation (the JAX package's
``viz/heatmap.py``).

  * CNN family (ResNet or Faster-RCNN tower): a channel-mean CAM over the
    tower's feature map (the FPN's ``pool`` level for Faster-RCNN, C5
    otherwise), min-max normalized per sample, resized to the source
    image, JET colour map, overlaid with weights 0.5 / 0.9.
  * ViT family: attention rollout: per layer the mean over heads, plus the
    identity, rows normalized, the layers chained by matrix products; the
    CLS row over the patches is a 14x14 mask that scales the image, then
    JET.

Each sample goes to ``perfect_match_predictions/`` or
``imperfect_match_predictions/`` by WUPS == 1.0 (any of the top k when
k > 1), with ``heatmap_*.png``, ``original_*.png`` and a
``predictions.json``; ``generate_heatmaps`` returns the average test WUPS.

The harness is split in two so that the device never sends its large maps
to the host:

  * the device step (``heatmap_step``, ``make_infer_fn``): the forward under
    ``torch.inference_mode`` and the session's autocast, then the maps and
    the top k on the device (``compute_cam_batch``, ``rollout_mask_batch``:
    the ViT's stacked maps, [12, B, 12, 197, 197] fp32 at full width, are
    reduced to the [B, 14, 14] mask there); only the top-k ids and the
    small maps are copied back. The CAM forward computes the tower's
    features with ``compute_vision_features`` and feeds them to the model
    as ``vision_features``, so the Faster-RCNN tower computes its ``pool``
    level alone;
  * the host step (``generate_heatmaps``): the overlays, the PNGs,
    ``predictions.json``, the routing by WUPS and the average. It needs
    OpenCV (``cv2``) and raises ``ImportError`` without it.

The numpy forms (``compute_cam``, ``attention_rollout``, ``rollout_mask``,
the overlays) are JAX's, for one sample; ``generate_heatmaps`` also takes
an ``infer_fn`` that returns JAX's outputs (``log_probs`` and
``features`` or ``attentions``) and reduces them with those.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch

from ..eval.predict import convert_logits_to_predictions_topk
from ..eval.wups import wup_measure

# batch keys that stay on the host (the eval records and the labels)
_HOST_KEYS = ("answers", "questions", "image_fns", "annotation_ids")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the heatmap overlays and PNGs need OpenCV (cv2), which does not "
            "import here; the device step (heatmap_step) runs without it"
        ) from e
    return cv2


# ---------------------------------------------------------------- numpy math

def compute_cam(features: np.ndarray) -> np.ndarray:
    """[H, W, C] (NHWC) feature map -> [H, W] channel-mean CAM, min-max
    normalized."""
    cam = features.mean(axis=-1)
    rng = cam.max() - cam.min()
    return (cam - cam.min()) / (rng if rng > 0 else 1.0)


def attention_rollout(att_layers: np.ndarray) -> np.ndarray:
    """[L, H, S, S] per-layer attention -> [S, S] joint attention: mean over
    heads, + I, rows normalized, chained by matrix products."""
    att = att_layers.mean(axis=1)                       # [L, S, S]
    S = att.shape[-1]
    aug = att + np.eye(S, dtype=att.dtype)
    aug = aug / aug.sum(axis=-1, keepdims=True)
    joint = aug[0]
    for n in range(1, aug.shape[0]):
        joint = aug[n] @ joint
    return joint


def rollout_mask(att_layers: np.ndarray) -> np.ndarray:
    """The CLS row's attention over the patches -> [g, g] grid."""
    joint = attention_rollout(att_layers)
    g = int(np.sqrt(joint.shape[-1] - 1))
    return joint[0, 1:].reshape(g, g)


def overlay_cam(image_bgr: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """JET overlay, weights 0.5 / 0.9."""
    cv2 = _cv2()
    heat = cv2.resize(cam.astype(np.float32),
                      (image_bgr.shape[1], image_bgr.shape[0]))
    heat = np.uint8(255 * heat)
    heat = cv2.applyColorMap(heat, cv2.COLORMAP_JET)
    return cv2.addWeighted(image_bgr, 0.5, heat, 0.9, 0)


def overlay_rollout(image_bgr: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The image scaled by the mask (resized to it), then JET."""
    cv2 = _cv2()
    m = cv2.resize(mask / max(mask.max(), 1e-12),
                   (image_bgr.shape[1], image_bgr.shape[0]))[..., np.newaxis]
    return cv2.applyColorMap((m * image_bgr).astype("uint8"),
                             cv2.COLORMAP_JET)


# -------------------------------------------------------------- device forms

def compute_cam_batch(features: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] feature maps -> [B, H, W] fp32 CAMs, ``compute_cam`` per
    sample (fp32 under any autocast)."""
    with torch.autocast(features.device.type, enabled=False):
        cam = features.float().mean(dim=-1)
        lo = cam.amin(dim=(1, 2), keepdim=True)
        rng = cam.amax(dim=(1, 2), keepdim=True) - lo
        return (cam - lo) / torch.where(rng > 0, rng, torch.ones_like(rng))


def rollout_mask_batch(attentions: torch.Tensor) -> torch.Tensor:
    """[L, B, H, S, S] stacked attention maps -> [B, g, g] fp32 masks,
    ``rollout_mask`` per sample (the same products in the same order, in
    fp32 under any autocast)."""
    with torch.autocast(attentions.device.type, enabled=False):
        att = attentions.float().mean(dim=2)            # [L, B, S, S]
        S = att.shape[-1]
        aug = att + torch.eye(S, dtype=att.dtype, device=att.device)
        aug = aug / aug.sum(dim=-1, keepdim=True)
        joint = aug[0]
        for n in range(1, aug.shape[0]):
            joint = torch.matmul(aug[n], joint)
    g = int(np.sqrt(S - 1))
    return joint[:, 0, 1:].reshape(-1, g, g)


def heatmap_step(model: torch.nn.Module, batch: Mapping[str, torch.Tensor],
                 mode: str, top_k: int) -> Dict[str, torch.Tensor]:
    """The device step on a device batch (no labels): ``{"topk": [B, k]
    answer ids, best first, "maps": [B, h, w] fp32, "log_probs": [B, A]}``,
    all left on the device. ``mode`` "cam" takes a CNN-family model,
    "rollout" a ViT-family one. Call it under ``torch.inference_mode`` and
    the compute dtype's autocast (``make_infer_fn`` does)."""
    if mode == "cam":
        batch = dict(batch)
        features = model.compute_vision_features(batch.pop("image_tensors"))
        log_probs = model(**batch, vision_features=features)[0]
        maps = compute_cam_batch(features)
    elif mode == "rollout":
        log_probs, _, attentions = model(**batch, return_attentions=True)
        maps = rollout_mask_batch(attentions)
    else:
        raise ValueError(f"mode must be 'cam' or 'rollout', not {mode!r}")
    # stable: equal log-probs keep the answer space's order, as the
    # session's decoding (eval/predict.py) keeps it
    order = torch.sort(log_probs.float(), dim=-1, descending=True,
                       stable=True).indices
    return {"topk": order[:, :top_k], "maps": maps, "log_probs": log_probs}


def make_infer_fn(model: torch.nn.Module, mode: str, top_k: int,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> Callable[[Mapping[str, np.ndarray]], Dict[str, np.ndarray]]:
    """``infer_fn`` for ``generate_heatmaps``: a host batch to the model's
    device, ``heatmap_step`` under ``inference_mode`` and autocast to
    ``compute_dtype``, and the top-k ids and maps back as numpy (the only
    device-to-host copies). The model is put in ``eval()``."""
    from ..train.trainer import _autocast

    model.eval()
    device = next(model.parameters()).device

    def infer_fn(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        on_device = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            device, non_blocking=True) for k, v in batch.items()}
        with torch.inference_mode(), _autocast(device, compute_dtype):
            out = heatmap_step(model, on_device, mode, top_k)
        return {k: out[k].cpu().numpy() for k in ("topk", "maps")}

    return infer_fn


# ------------------------------------------------------------------ harness

def _topk_and_maps(out: Mapping[str, np.ndarray], mode: str, top_k: int,
                   valid: int):
    """([valid, k] top-k ids, [valid, h, w] maps) from ``make_infer_fn``'s
    output, or from JAX's (log-probs and the raw features or attentions)
    reduced with the numpy forms."""
    if "maps" in out:
        return (np.asarray(out["topk"])[:valid, :top_k],
                np.asarray(out["maps"])[:valid])
    topk = convert_logits_to_predictions_topk(
        np.asarray(out["log_probs"])[:valid], top_k)
    if mode == "cam":
        features = np.asarray(out["features"])
        maps = [compute_cam(features[b]) for b in range(valid)]
    else:
        attentions = np.asarray(out["attentions"])
        maps = [rollout_mask(attentions[:, b]) for b in range(valid)]
    return topk, np.stack(maps)


def generate_heatmaps(
    infer_fn: Callable[[dict], Dict[str, np.ndarray]],
    dataloader,
    answer_spaces: List[str],
    output_dir: str,
    mode: str = "cam",            # "cam" | "rollout"
    top_k: int = 1,
) -> float:
    """Test-set inference and visualization; returns (and prints) the
    average test WUPS.

    ``infer_fn(device_batch)`` returns either ``make_infer_fn``'s
    ``{"topk", "maps"}`` or, as in the JAX package, ``{"log_probs": [B, A]}``
    with ``"features"`` ([B, h, w, C] NHWC) for mode="cam" or
    ``"attentions"`` ([L, B, H, S, S]) for mode="rollout".
    """
    cv2 = _cv2()
    os.makedirs(output_dir, exist_ok=True)
    perfect_dir = os.path.join(output_dir, "perfect_match_predictions")
    imperfect_dir = os.path.join(output_dir, "imperfect_match_predictions")
    os.makedirs(perfect_dir, exist_ok=True)
    os.makedirs(imperfect_dir, exist_ok=True)

    all_predictions: List[int] = []
    all_targets: List[int] = []

    for idx, batch in enumerate(dataloader):
        valid = int(batch.get("_valid", len(batch["annotation_ids"])))
        questions = batch["questions"][:valid]
        image_fns = batch["image_fns"][:valid]
        annotation_ids = np.asarray(batch["annotation_ids"])[:valid]

        device_batch = {k: v for k, v in batch.items()
                        if k not in _HOST_KEYS and not k.startswith("_")}
        topk, maps = _topk_and_maps(infer_fn(device_batch), mode, top_k,
                                    valid)
        preds = topk[:, 0]
        all_predictions.extend(preds.tolist())
        all_targets.extend(annotation_ids.tolist())

        for b in range(valid):
            image = cv2.imread(image_fns[b])
            overlay = (overlay_cam(image, maps[b]) if mode == "cam"
                       else overlay_rollout(image, maps[b]))

            target_text = answer_spaces[int(annotation_ids[b])]
            hit_text = None
            for p in topk[b]:
                if wup_measure(answer_spaces[int(p)], target_text) == 1.0:
                    hit_text = answer_spaces[int(p)]
                    break

            base = perfect_dir if hit_text is not None else imperfect_dir
            sample_dir = os.path.join(base, f"{idx}_{b}_heatmap_predictions")
            os.makedirs(sample_dir, exist_ok=True)
            cv2.imwrite(os.path.join(sample_dir, f"heatmap_{idx}_{b}.png"),
                        overlay)
            cv2.imwrite(os.path.join(sample_dir, f"original_{idx}_{b}.png"),
                        image)
            record = {
                "question": questions[b].question_text,
                "predicted_answer": answer_spaces[int(preds[b])],
                "target_answer": target_text,
                "wups_score": wup_measure(answer_spaces[int(preds[b])],
                                          target_text),
            }
            if top_k > 1:
                record["topk_predictions"] = [answer_spaces[int(p)]
                                              for p in topk[b]]
                record["topk_hit"] = hit_text
            with open(os.path.join(sample_dir, "predictions.json"), "w") as f:
                json.dump(record, f)

    scores = [wup_measure(answer_spaces[p], answer_spaces[t])
              for p, t in zip(all_predictions, all_targets)]
    avg = sum(scores) / len(scores) if scores else 0.0
    print(f"Average Test WUPS Score: {avg:.4f}")
    return avg
