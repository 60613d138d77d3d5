"""ResNet-18/34/50 vision backbone with frozen BatchNorm.

PyTorch counterpart of ``t5_resnet_vqa_tpu/models/resnet.py``, with
torchvision's ``state_dict`` keys (``layer1.0.conv1.weight``,
``downsample.0``/``downsample.1``, the BN buffers and the unused ``fc``).
v1.5 blocks carry the stride on the 3x3; the stem is the plain 7x7/s2 conv
(the JAX package's space-to-depth stem is the same math, shaped for the
TPU's matrix unit).

Activations run in ``channels_last``: the model hands the backbone an NHWC
batch viewed as NCHW, and the convolutions keep that layout, so
``x.permute(0, 2, 3, 1)`` gives the bottleneck kernel a contiguous NHWC
tensor at no cost. With ``use_kernel``, the ResNet-50 blocks of
``FUSED_STAGES`` go through ``ops.bottleneck.fused_bottleneck_packed`` (the
counterpart of ``fused_backbone_apply``, resnet.py:174, at its default
``fuse_stages``), everything else through the modules.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops.bottleneck import (
    fold_conv_bn,
    fused_bottleneck_packed,
    pack_operands,
)

# (block type, stage depths, stage base widths, expansion)
_VARIANTS = {
    "resnet18": ("basic", (2, 2, 2, 2), (64, 128, 256, 512), 1),
    "resnet34": ("basic", (3, 4, 6, 3), (64, 128, 256, 512), 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), (64, 128, 256, 512), 4),
}

# stages whose bottleneck widths (64, 128) the fused kernel takes
FUSED_STAGES = (0, 1)


def resnet_out_channels(variant: str) -> int:
    _, _, widths, expansion = _VARIANTS[variant]
    return widths[-1] * expansion


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm: y = x * scale + bias per channel, with
    scale = weight / sqrt(running_var + eps), bias = bias - mean * scale."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def folded(self):
        """(scale, bias) in fp32."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.folded()
        return (x * scale.to(x.dtype)[:, None, None]
                + bias.to(x.dtype)[:, None, None])


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=(kernel - 1) // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = FrozenBatchNorm(width)
        self.downsample = (_downsample(cin, width, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """v1.5 bottleneck: 1x1 reduce, 3x3 (carries the stride), 1x1 expand.

    The fused path's operands (BN folded into the convolutions, packed for
    the kernel) are computed when the weights are set, not per forward: at
    construction, after ``load_state_dict`` (a post-hook), after a dtype or
    device move (``_apply``), and by ``refresh_fused_operands`` after any
    other in-place change to the weights (``init_weights`` calls it).
    """

    def __init__(self, cin: int, width: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.downsample = (_downsample(cin, width * 4, stride)
                           if has_downsample else None)
        self.refresh_fused_operands()
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.refresh_fused_operands())

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        self.refresh_fused_operands()
        return out

    def refresh_fused_operands(self) -> None:
        """Fold and pack the fused path's operands from the weights as they
        are now, in the weights' dtype."""
        with torch.no_grad():
            self.fused = pack_operands(
                *self.fused_operands(self.conv1.weight.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)

    def fused_operands(self, dtype: torch.dtype):
        """(w1, b1, w2, b2, w3, b3, wd, bd): the BN-folded operands of
        ``fused_bottleneck``; wd and bd are None without a downsample."""
        ops = []
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            ops.extend(fold_conv_bn(conv.weight, *bn.folded(), dtype))
        if self.downsample is None:
            ops.extend((None, None))
        else:
            conv, bn = self.downsample
            ops.extend(fold_conv_bn(conv.weight, *bn.folded(), dtype))
        return ops

    def forward_fused(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The same block on NHWC input (the weights' dtype) through the
        fused kernel, with the operands packed when the weights were set."""
        return fused_bottleneck_packed(x_nhwc, self.fused, stride=self.stride)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages; returns [C2, C3, C4, C5] (NCHW, channels_last)."""

    def __init__(self, variant: str = "resnet50", use_kernel: bool = False):
        super().__init__()
        block_type, depths, widths, expansion = _VARIANTS[variant]
        block_cls = BasicBlock if block_type == "basic" else Bottleneck
        self.fused_stages = (FUSED_STAGES if use_kernel
                             and block_type == "bottleneck" else ())
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for stage, (depth, width) in enumerate(zip(depths, widths)):
            stride = 1 if stage == 0 else 2
            out_ch = width * expansion
            blocks = [block_cls(in_ch if b == 0 else out_ch, width,
                                stride if b == 0 else 1,
                                b == 0 and (stride != 1 or in_ch != out_ch))
                      for b in range(depth)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            in_ch = out_ch
        self.fc = nn.Linear(in_ch, 1000)     # unused; kept for strict loading

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        feats = []
        for stage in range(4):
            layer = getattr(self, f"layer{stage + 1}")
            if stage in self.fused_stages:
                h_nhwc = h.permute(0, 2, 3, 1).contiguous()
                for block in layer:
                    h_nhwc = block.forward_fused(h_nhwc)
                h = h_nhwc.permute(0, 3, 1, 2)
            else:
                h = layer(h)
            feats.append(h)
        return feats
