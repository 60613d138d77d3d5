"""Fused unmasked attention: a hand-written CUDA kernel and its plain version.

Counterpart of ``t5_resnet_vqa_tpu/ops/pallas/attention.py``:
``fused_attention`` here stands for both ``fused_attention`` (:77) and
``fused_attention_grad_safe`` (:139) there. For a CUDA tensor it launches
``csrc/attention.cu`` (bf16 on the tensor cores, 16 query rows of one head
per warp; see the source note for what bounds it and why it is shaped so)
inside a ``torch.autograd.Function`` whose backward is the VJP of
``attention_reference``, the counterpart of ``_fas_bwd``. For a CPU tensor
it returns ``attention_reference``, the same math in plain PyTorch. There is
no fallback: a CUDA tensor the kernel does not take raises.

The kernel reads q, k and v in place: strided [B, H, S, D] views whose last
dimension is contiguous, such as the head split of a [B, S, H*D] projection,
as long as every row starts 16-byte aligned (contiguous tensors are always
taken). It writes its output as a contiguous [B, Sq, H, D] tensor and
returns the [B, H, Sq, D] view of it, so merging the heads back is a free
reshape.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel; ``vjps`` counts the backward passes of launched
kernels (each the plain version's VJP: no kernel is launched there).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import kernel_build

launches = 0
vjps = 0

_MAX_SK = 256
_MAX_D = 128
_WARPS_F32 = 8
_MAX_SMEM = 232448          # H100: dynamic shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0,
                        dropout: Optional[torch.nn.Module] = None
                        ) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, H, Sq, D] / [B, H, Sk, D].

    Scores and softmax in fp32; the probabilities are cast to the query
    dtype before P.V, which accumulates in fp32; the output has q's dtype
    (``ops/layers.py:dot_product_attention`` of the JAX package). ``mask``
    marks masked positions with True and fills them with -1e9; ``dropout``,
    where given, drops the probabilities in place of ``F.dropout``. Autocast is
    off inside, so that the fp32 products stay fp32 under a bf16 autocast.
    """
    d = q.shape[-1]
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(d)
        if mask is not None:
            scores = scores.masked_fill(mask, -1e9)
        att = torch.softmax(scores, dim=-1).to(q.dtype)
        if dropout_p > 0.0:
            att = (torch.nn.functional.dropout(att, dropout_p)
                   if dropout is None else dropout(att))
        return torch.matmul(att.float(), v.float()).to(q.dtype)


def _smem_bytes_f32(sk: int, d: int) -> int:
    """Shared memory of the fp32 kernel (csrc smem_f32); the bf16 kernel's
    fits for every accepted shape."""
    return (2 * sk * (d + 1) + _WARPS_F32 * (d + sk)) * 4


def _rows_aligned(t: torch.Tensor, align: int) -> bool:
    """Every [.., s, :] row of ``t`` starts ``align``-byte aligned."""
    size = t.element_size()
    return t.data_ptr() % align == 0 and all(
        (st * size) % align == 0 for st in t.stride()[:3])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must share q's device and dtype")
        if t.dim() != 4:
            raise ValueError(f"{name} must be a [B, H, S, D] tensor, got "
                             f"shape {tuple(t.shape)}")
        if not (t.is_contiguous() and _rows_aligned(t, 4)) and not (
                t.stride(3) == 1 and _rows_aligned(t, 16)):
            raise ValueError(f"{name} must be contiguous, or a view with a "
                             f"contiguous last dimension and 16-byte aligned "
                             f"rows; got strides {t.stride()}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (0 < Sk <= _MAX_SK and 0 < D <= _MAX_D and D % 2 == 0):
        raise ValueError(f"fused_attention takes Sk <= {_MAX_SK} and even "
                         f"D <= {_MAX_D}, got Sk={Sk}, D={D}")
    if q.dtype == torch.float32 and _smem_bytes_f32(Sk, D) > _MAX_SMEM:
        raise ValueError(f"Sk={Sk}, D={D} in {q.dtype} needs more shared "
                         f"memory than one block has")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    fn = kernel_build.function("attention", "attention_forward", _ARGTYPES)
    B, H, Sq, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Sq, k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], _DTYPES[q.dtype], stream)
    kernel_build.check(status, "attention_forward")
    launches += 1
    return out.transpose(1, 2)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        global vjps
        vjps += 1
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_reference(qq, kk, vv)
            return torch.autograd.grad(out, (qq, kk, vv), g)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention over q [B, H, Sq, D], k/v [B, H, Sk, D].

    CPU tensors: the plain version. CUDA tensors: the kernel, or an error;
    its result is the [B, H, Sq, D] view of a contiguous [B, Sq, H, D].
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, "
                         f"not {q.device}")
    _check(q, k, v)
    return _FusedAttention.apply(q, k, v)
