"""Heatmaps and the test-set WUPS evaluation (``viz/heatmap.py``); the CLI
is ``python -m t5_resnet_vqa_torch.viz --mode cam|rollout``."""

from .heatmap import (
    attention_rollout,
    compute_cam,
    compute_cam_batch,
    generate_heatmaps,
    heatmap_step,
    make_infer_fn,
    overlay_cam,
    overlay_rollout,
    rollout_mask,
    rollout_mask_batch,
)

__all__ = [
    "compute_cam", "attention_rollout", "rollout_mask",
    "overlay_cam", "overlay_rollout", "generate_heatmaps",
    "compute_cam_batch", "rollout_mask_batch", "heatmap_step",
    "make_infer_fn",
]
