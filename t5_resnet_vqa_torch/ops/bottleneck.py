"""Fused frozen ResNet-50 bottleneck: a hand-written CUDA kernel and its
plain version.

Counterpart of ``t5_resnet_vqa_tpu/ops/pallas/bottleneck.py``
(``fused_bottleneck`` :180, ``_block_kernel`` :84). The block's BatchNorms
are folded into its convolutions first (``fold_conv_bn``: fp32 multiply,
then cast to the activation dtype; the bias stays fp32, as at :202-208), so
the function computes, in NHWC::

    t1  = relu(x @ w1 + b1)
    t2  = relu(im2col3x3(t1, stride) @ w2 + b2)
    out = relu(t2 @ w3 + b3 + (x[::s, ::s] @ wd + bd  or  x))

For a CUDA tensor ``fused_bottleneck`` launches ``csrc/bottleneck.cu``
(persistent thread blocks walking 8x16 output tiles, t1 and t2 kept in
shared memory, weights streamed through a ring of bulk copies; see the
source note), stride 2 with downsample included. For a CPU tensor it
returns ``bottleneck_reference``. There is no fallback: a CUDA tensor the
kernel does not take raises. Forward only: the tower is frozen, and an
input that requires a gradient raises (on the CPU too, so that the plain
route behaves as the kernel's).

The bf16 kernel reads its weights packed: ``pack_operands`` cuts each
folded weight into the 64-row chunks the kernel streams, in the order it
streams them, each row padded with 8 zeros as in shared memory, so that a
chunk is one contiguous bulk copy. ``Bottleneck`` (``models/resnet.py``)
packs once when its weights are set and calls ``fused_bottleneck_packed``;
``fused_bottleneck`` packs on every call. fp32 operands stay unpacked.

``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from . import kernel_build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
KC = 64          # K rows per chunk (csrc KC)
NMAX = 128       # conv3 / downsample columns per chunk (csrc NMAX)
PAD = 8          # zeros after every chunk row (csrc kPad)


def fold_conv_bn(conv_weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW conv weight and folded BN (scale, bias) -> the kernel's operands:
    the HWIO kernel times the scale in fp32, cast to ``dtype`` and flattened
    to [kh*kw*I, O] (tap-major rows), and the fp32 bias."""
    w = conv_weight.float().permute(2, 3, 1, 0) * scale.float()
    return (w.to(dtype).reshape(-1, w.shape[-1]).contiguous(),
            bias.float().contiguous())


def pack_weight(w: torch.Tensor, n: int) -> torch.Tensor:
    """[K, N] -> [N / n, K / 64, 64, n + 8]: column block j, then 64-row
    chunk c, each row followed by 8 zeros. Flattened, it is the order in
    which the kernel streams the chunks (w1, w2: n = N; w3, wd: n = 128)."""
    K, N = w.shape
    chunks = w.reshape(K // KC, KC, N // n, n).permute(2, 0, 1, 3)
    return torch.nn.functional.pad(chunks, (0, PAD)).contiguous()


def unpack_weight(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_weight``."""
    nb, kc, rows, n = packed.shape
    n -= PAD
    return packed[..., :n].permute(1, 2, 0, 3).reshape(kc * rows, nb * n)


@dataclasses.dataclass(frozen=True)
class PackedBottleneck:
    """A block's folded operands, ``plain`` as ``fold_conv_bn`` gives them
    (w1, b1, w2, b2, w3, b3, wd, bd; wd and bd None without a downsample),
    and ``kernel``: the same in the kernel's layout (bf16 weights packed,
    fp32 ones as they are)."""
    plain: Tuple[Optional[torch.Tensor], ...]
    kernel: Tuple[Optional[torch.Tensor], ...]


def pack_operands(w1, b1, w2, b2, w3, b3, wd=None, bd=None
                  ) -> PackedBottleneck:
    """``fold_conv_bn``'s operands of one block, with their kernel layout."""
    plain = (w1, b1, w2, b2, w3, b3, wd, bd)
    if w1.dtype != torch.bfloat16:
        return PackedBottleneck(plain, plain)
    kernel = (pack_weight(w1, w1.shape[1]), b1, pack_weight(w2, w2.shape[1]),
              b2, pack_weight(w3, NMAX), b3,
              None if wd is None else pack_weight(wd, NMAX), bd)
    return PackedBottleneck(plain, kernel)


def bottleneck_reference(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                         wd: Optional[torch.Tensor] = None,
                         bd: Optional[torch.Tensor] = None,
                         stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the fused block, x [B, H, W, Cin] NHWC.

    Mirrors the TPU kernel body step by step: products of the activation
    dtype accumulate in fp32, bias and ReLU in fp32, the 3x3 as one im2col
    product with K = 9*Cw in tap-major order.
    """
    B, H, W, Cin = x.shape
    Cw = w1.shape[1]
    Ho, Wo = H // stride, W // stride
    dt = x.dtype
    f32 = torch.float32

    t1 = torch.relu(x.reshape(-1, Cin).to(f32) @ w1.to(f32) + b1).to(dt)
    t1p = torch.nn.functional.pad(t1.reshape(B, H, W, Cw), (0, 0, 1, 1, 1, 1))
    taps = [t1p[:, di:di + (Ho - 1) * stride + 1:stride,
                dj:dj + (Wo - 1) * stride + 1:stride, :]
            for di in range(3) for dj in range(3)]
    col = torch.cat(taps, dim=-1).reshape(-1, 9 * Cw)
    t2 = torch.relu(col.to(f32) @ w2.to(f32) + b2).to(dt)
    y = t2.to(f32) @ w3.to(f32) + b3
    if wd is not None:
        xs = x[:, ::stride, ::stride, :].reshape(-1, Cin)
        idn = xs.to(f32) @ wd.to(f32) + bd
    else:
        idn = x.reshape(-1, Cin).to(f32)
    return torch.relu(y + idn).to(dt).reshape(B, Ho, Wo, -1)


def _check(x, w1, b1, w2, b2, w3, b3, wd, bd, stride) -> None:
    """Checks the plain operands (``PackedBottleneck.plain``)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_bottleneck takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, Cin = x.shape
    Cw, Cout = w1.shape[1], w3.shape[1]
    weights = [("x", x, None), ("w1", w1, (Cin, Cw)), ("w2", w2, (9 * Cw, Cw)),
               ("w3", w3, (Cw, Cout))]
    biases = [("b1", b1, Cw), ("b2", b2, Cw), ("b3", b3, Cout)]
    if wd is not None:
        weights.append(("wd", wd, (Cin, Cout)))
        biases.append(("bd", bd, Cout))
    for name, t, shape in weights:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} must share x's device and dtype")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t, n in biases:
        if t is None or t.device != x.device or t.dtype != torch.float32 \
                or t.numel() != n:
            raise ValueError(f"{name} must be a float32 tensor of {n} "
                             f"values on x's device")
    for name, t, _ in weights + biases:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if stride not in (1, 2) or H % stride or W % stride:
        raise ValueError(f"stride {stride} must be 1 or 2 and divide "
                         f"H={H}, W={W}")
    if Cin % 64 or Cw not in (64, 128) or Cout % 128:
        raise ValueError(f"fused_bottleneck takes Cin % 64 == 0, Cw in "
                         f"(64, 128), Cout % 128 == 0; got Cin={Cin}, "
                         f"Cw={Cw}, Cout={Cout}")
    if wd is None and (stride != 1 or Cin != Cout):
        raise ValueError("a block without downsample needs stride 1 and "
                         "Cin == Cout")


def _launch(x, packed: PackedBottleneck, stride) -> torch.Tensor:
    global launches
    fn = kernel_build.function("bottleneck", "bottleneck_forward", _ARGTYPES)
    w1, b1, w2, b2, w3, b3, wd, bd = packed.kernel
    B, H, W, Cin = x.shape
    Cw, Cout = packed.plain[0].shape[1], packed.plain[4].shape[1]
    out = torch.empty((B, H // stride, W // stride, Cout), dtype=x.dtype,
                      device=x.device)
    has_ds = wd is not None
    status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                wd.data_ptr() if has_ds else None,
                bd.data_ptr() if has_ds else None, out.data_ptr(),
                B, H, W, Cin, Cw, Cout, stride, int(has_ds), _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(status, "bottleneck_forward")
    launches += 1
    return out


def _check_no_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_bottleneck has no backward: call it under "
                           "torch.no_grad() on an input that needs no "
                           "gradient")


def fused_bottleneck(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                     wd: Optional[torch.Tensor] = None,
                     bd: Optional[torch.Tensor] = None,
                     stride: int = 1) -> torch.Tensor:
    """One frozen bottleneck on x [B, H, W, Cin] NHWC with folded weights.

    CPU tensors: the plain version. CUDA tensors: the kernel, or an error.
    """
    _check_no_grad(x)
    if x.device.type == "cpu":
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd, stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, "
                         f"not {x.device}")
    _check(x, w1, b1, w2, b2, w3, b3, wd, bd, stride)
    return _launch(x, pack_operands(w1, b1, w2, b2, w3, b3, wd, bd), stride)


def fused_bottleneck_packed(x: torch.Tensor, packed: PackedBottleneck,
                            stride: int = 1) -> torch.Tensor:
    """``fused_bottleneck`` with operands packed once by ``pack_operands``."""
    _check_no_grad(x)
    if x.device.type == "cpu":
        return bottleneck_reference(x, *packed.plain, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on cuda or cpu, "
                         f"not {x.device}")
    _check(x, *packed.plain, stride)
    return _launch(x, packed, stride)
