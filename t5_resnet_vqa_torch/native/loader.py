"""Build ``preproc.cpp`` with the machine's g++ and load it with ctypes.

The library is built at first use into the package's ``_build/`` directory,
under a name keyed on a hash of the source and the flags (the flags of the
JAX package's ``native/Makefile``), so an edited source builds anew and an
unchanged one is reused. A build that fails raises with the compiler's
message: the fp32 image path must not quietly switch to another resize,
whose pixels differ.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "preproc.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17",
            "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional["NativePreproc"] = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libvqapreproc-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native image "
                           "resize, t5_resnet_vqa_torch/native/preproc.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    done = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{done.stderr}")
    os.replace(tmp, out)        # atomic: a reader never sees half a file
    return out


class NativePreproc:
    """``resize_bilinear_scale`` of the library, with its ctypes signature."""

    def __init__(self, lib: ctypes.CDLL):
        self._fn = lib.resize_bilinear_scale
        self._fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        self._fn.restype = None

    def resize_scale_batch(
        self,
        images: Sequence[np.ndarray],
        out_hw: Tuple[int, int],
        normalize: Optional[Tuple[Sequence[float], Sequence[float]]],
    ) -> np.ndarray:
        """RGB uint8 [h, w, 3] images -> float32 [B, H, W, 3]: bilinear
        resize, /255, then ``(x - mean) / std`` when ``normalize`` is given,
        all in fp32."""
        H, W = out_hw
        out = np.empty((len(images), H, W, 3), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        mean_p = std_p = None
        if normalize is not None:
            mean = np.ascontiguousarray(normalize[0], np.float32)
            std = np.ascontiguousarray(normalize[1], np.float32)
            if mean.shape != (3,) or std.shape != (3,):
                raise ValueError("normalize needs 3 means and 3 stds")
            mean_p, std_p = mean.ctypes.data_as(fp), std.ctypes.data_as(fp)
        for i, img in enumerate(images):
            img = np.ascontiguousarray(img, np.uint8)
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"expected an RGB [h, w, 3] image, got "
                                 f"{img.shape}")
            self._fn(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     img.shape[0], img.shape[1], out[i].ctypes.data_as(fp),
                     H, W, mean_p, std_p)
        return out


def get_lib() -> NativePreproc:
    """The loaded library, built first if needed (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = NativePreproc(ctypes.CDLL(build()))
        return _lib
