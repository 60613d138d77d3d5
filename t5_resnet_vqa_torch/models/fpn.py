"""Feature Pyramid Network over the ResNet-50 body (Faster-RCNN tower).

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/fpn.py``, with
torchvision's ``FeaturePyramidNetwork`` keys (``inner_blocks.{i}`` and
``layer_blocks.{i}``, plain convolutions with a bias):

  inner_i = Conv1x1(C_i)                      (lateral, out_channels)
  top-down: inner_i += nearest 2x upsample of inner_{i+1}
  P_i     = Conv3x3(inner_i)                  (smoothing)
  pool    = P_last[:, :, ::2, ::2]            (LastLevelMaxPool, kernel 1)

The VQA forward and the feature cache read only ``pool``, which depends on
the last level alone (``inner_3`` and ``layer_3`` of C5). Under ``jit`` the
JAX package's compiler drops the other levels as dead code; eager PyTorch
would compute them, about two thirds of the ResNet-50 body's own work at
256^2. So the FPN computes every level only when ``all_levels`` is asked
for (the heatmap path); the ``pool`` level is the same either way.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class FPN(nn.Module):
    """Top-down FPN over [C2, C3, C4, C5] (NCHW); returns
    {'0', '1', '2', '3', 'pool'} with ``all_levels``, else {'pool'}."""

    def __init__(self, in_channels_list: Sequence[int],
                 out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels_list])
        self.layer_blocks = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, padding=1)
             for _ in in_channels_list])

    def forward(self, feats: List[torch.Tensor],
                all_levels: bool = False) -> Dict[str, torch.Tensor]:
        n = len(feats)
        last = self.inner_blocks[-1](feats[-1])
        top = self.layer_blocks[-1](last)
        outs = {"pool": top[:, :, ::2, ::2]}
        if not all_levels:
            return outs
        outs[str(n - 1)] = top
        for i in range(n - 2, -1, -1):
            inner = self.inner_blocks[i](feats[i])
            last = inner + F.interpolate(last, size=inner.shape[-2:],
                                         mode="nearest")
            outs[str(i)] = self.layer_blocks[i](last)
        return {k: outs[k] for k in [str(i) for i in range(n)] + ["pool"]}
