"""Host-side image preprocessing: decode -> RGB -> resize -> scale/normalize.

The JAX package's ``data/preprocessing.py``: cv2.imread (BGR) -> cvtColor
RGB -> resize -> float in [0, 1] (ToTensor parity, unnormalized as the CNN
family takes it; the ViT family also normalizes with the image processor's
mean and std), NHWC. The float path resizes bilinearly in fp32 through the
native library (``native/preproc.cpp``) when ``use_native`` is set, as the
JAX package does; otherwise, and for the other interpolations and the
uint8 wire, cv2 resizes in uint8. The two differ by up to one uint8 step.
Unlike the JAX package, a native library that cannot be built raises
instead of falling back to cv2. ``cv2`` is imported inside the functions,
so the module imports on machines without it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_CV2_INTERP = {
    "bilinear_interpolation": 1,   # cv2.INTER_LINEAR
    "lanczos_interpolation": 4,    # cv2.INTER_LANCZOS4
    "bicubic_interpolation": 2,    # cv2.INTER_CUBIC
}


def decode_image(path: str) -> np.ndarray:
    """File -> RGB uint8 HWC array."""
    import cv2

    arr = cv2.imread(path, cv2.IMREAD_COLOR)
    if arr is None:
        raise FileNotFoundError(f"cannot decode image: {path}")
    return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)


def load_and_resize_image(
    path: str,
    size: Tuple[int, int],
    interpolation_strategy: str = "bilinear_interpolation",
) -> np.ndarray:
    """-> resized RGB uint8 [H, W, 3]."""
    import cv2

    img = decode_image(path)
    w, h = size
    return cv2.resize(img, (w, h),
                      interpolation=_CV2_INTERP[interpolation_strategy])


def finalize_image(
    img_u8: np.ndarray,
    normalize: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [H, W, 3] in [0, 1], then
    ``(x - mean) / std`` in float32 when ``normalize`` is given."""
    out = img_u8.astype(np.float32) / 255.0
    if normalize is not None:
        mean, std = normalize
        out = (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return out


def load_image_batch(
    paths: Sequence[str],
    size: Tuple[int, int],
    interpolation_strategy: str = "bilinear_interpolation",
    normalize: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
    use_native: bool = True,
    emit_uint8: bool = False,
) -> np.ndarray:
    """-> [B, H, W, 3] float32 NHWC batch (normalized when ``normalize`` is
    given), or the resized uint8 batch when ``emit_uint8`` (the model then
    scales and normalizes on the device). ``use_native`` sends a bilinear
    float batch through the native fp32 resize; it is ignored under
    ``emit_uint8``."""
    w, h = size
    paths = list(paths)
    if (use_native and not emit_uint8
            and interpolation_strategy == "bilinear_interpolation"):
        from ..native import loader
        return loader.get_lib().resize_scale_batch(
            [decode_image(p) for p in paths], (h, w), normalize)
    out = np.empty((len(paths), h, w, 3),
                   np.uint8 if emit_uint8 else np.float32)
    for i, path in enumerate(paths):
        img = load_and_resize_image(path, size, interpolation_strategy)
        out[i] = img if emit_uint8 else finalize_image(img, normalize)
    return out
