"""On-device image finalization for the uint8 wire format.

The collates can ship resized uint8 images, so the host-to-device copy
carries 1 byte per pixel instead of 4; the /255 rescale then runs as the
model's first device op. Float inputs pass through untouched.
"""

from __future__ import annotations

import torch


def finalize_image_input(x: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> fp32 in [0, 1], as
    ``data.preprocessing.finalize_image`` computes it on the host."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return x
