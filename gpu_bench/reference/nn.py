"""Plain building blocks of the reference models: functional PyTorch over a
dict of weights, in float32 with TF32 off.

Every product (linear, convolution, attention) goes through a
``Precision``. The reference proper uses float32. The control (the
reference computed one precision below the bfloat16 that the
configurations serve and train in) is an fp8 step: both operands of every
forward product rounded to float8 e4m3, and in the backward the incoming
gradient rounded to float8 e5m2 before its two products, each tensor with
its own scale (its largest magnitude at the format's largest finite).
``float64`` runs the whole reference in double precision: the yardstick
of the float32 reference's own rounding, which ``calibrate.py`` reads.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

FP8_MAX = {"float8_e4m3fn": 448.0, "float8_e5m2": 57344.0}


def no_tf32() -> None:
    """float32 products in float32: the reference never runs in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to the float8 format ``fmt`` with a per-tensor scale,
    back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX[fmt]
    return (x / scale).to(getattr(torch, fmt)).float() * scale


def _unbroadcast(grad: torch.Tensor, shape) -> torch.Tensor:
    """``grad`` summed over the dimensions a broadcast added or widened."""
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    for d, n in enumerate(shape):
        if n == 1 and grad.shape[d] != 1:
            grad = grad.sum(d, keepdim=True)
    return grad


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = _round(a, "float8_e4m3fn"), _round(b, "float8_e4m3fn")
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round(g, "float8_e5m2")
        return (_unbroadcast(torch.matmul(g, b.transpose(-1, -2)), a.shape),
                _unbroadcast(torch.matmul(a.transpose(-1, -2), g), b.shape))


class Precision:
    """The precision of the products: ``"float32"``, ``"float8"`` or
    ``"float64"`` (see the module's docstring); ``dtype`` is that of the
    weights and activations."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8", "float64"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name != "float8":
            return torch.matmul(a, b)
        return _Fp8Matmul.apply(a, b)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A convolution's operand (forward only: the convolutions feed no
        gradient the references take)."""
        if self.name != "float8":
            return x
        return _round(x.detach(), "float8_e4m3fn")


FP32 = Precision()


def linear(P: Precision, x, w, b=None):
    y = P.matmul(x, w.t())
    return y if b is None else y + b


def conv2d(P: Precision, x, w, b=None, stride=1, padding=0):
    return F.conv2d(P.operand(x), P.operand(w), b, stride=stride,
                    padding=padding)


def conv_transpose2d(P: Precision, x, w, b=None, stride=1, padding=0):
    return F.conv_transpose2d(P.operand(x), P.operand(w), b, stride=stride,
                              padding=padding)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def split_heads(x, head_dim: int):
    """[B, S, H*D] -> [B, H, S, D]."""
    B, S, _ = x.shape
    return x.reshape(B, S, -1, head_dim).transpose(1, 2)


def merge_heads(x):
    """[B, H, S, D] -> [B, S, H*D]."""
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def attention(P: Precision, q, k, v, scale: float,
              bias: Optional[torch.Tensor] = None):
    """softmax(q k^T * scale + bias) v over [B, H, S, D]."""
    s = P.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    return P.matmul(torch.softmax(s, dim=-1), v)


def attention_pool(P: Precision, W: Mapping[str, torch.Tensor], x,
                   prefix: str):
    """Linear(h -> 1) scores, softmax over the sequence, weighted sum."""
    w = torch.softmax(linear(P, x, W[prefix + "attention.0.weight"],
                             W[prefix + "attention.0.bias"]), dim=1)
    return (x * w).sum(1)


class Dropout:
    """Dropout that draws its masks as the program's CUDA (or CPU) dropout
    does: ``F.dropout`` on a tensor of ones of the same shape and dtype as
    the program's input at that site, from the same generator state, in
    the same order. The mask is applied in float32. With ``rows``, ``x``
    holds those rows of a batch of ``batch``: the batch's mask is drawn,
    and its rows applied."""

    def __init__(self, p: float, rows: Optional[slice] = None,
                 batch: int = 0):
        self.p, self.rows, self.batch = p, rows, batch

    def of_rows(self, rows: slice, batch: int) -> "Dropout":
        return Dropout(self.p, rows, batch)

    def __call__(self, x, dtype: torch.dtype):
        if self.p == 0.0:
            return x
        shape = x.shape if self.rows is None else (self.batch, *x.shape[1:])
        ones = torch.ones(shape, dtype=dtype, device=x.device)
        keep = F.dropout(ones, self.p, training=True) != 0
        if self.rows is not None:
            keep = keep[self.rows]
        return x * keep.to(x.dtype) / (1.0 - self.p)


NO_DROPOUT = Dropout(0.0)


def relative_position_bucket(relative_position, num_buckets: int,
                             max_distance: int):
    """T5's bidirectional bucket of ``memory - context`` (the published
    T5 code, ``T5Attention._relative_position_bucket``)."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (torch.log(n.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)
