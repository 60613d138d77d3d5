"""On-device image finalization for the uint8 wire format.

The collates can ship resized uint8 images, so the host-to-device copy
carries 1 byte per pixel instead of 4; the /255 rescale, and for the ViT
family the image processor's mean/std normalization, then run as the
model's first device op. Float inputs pass through untouched.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def finalize_image_input(
    x: torch.Tensor,
    normalize: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> fp32 in [0, 1], then ``(x - mean) / std`` in
    fp32 when ``normalize`` is given: the order of operations of
    ``data.preprocessing.finalize_image`` on the host, so the uint8 and fp32
    wires give the same values."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
        if normalize is not None:
            mean, std = normalize
            x = (x - torch.tensor(mean, dtype=torch.float32, device=x.device)
                 ) / torch.tensor(std, dtype=torch.float32, device=x.device)
    return x
