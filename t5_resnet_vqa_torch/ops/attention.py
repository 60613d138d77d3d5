"""Fused unmasked attention: hand-written CUDA kernels and their plain version.

Counterpart of ``t5_resnet_vqa_tpu/ops/pallas/attention.py``:
``fused_attention`` here stands for both ``fused_attention`` (:77) and
``fused_attention_grad_safe`` (:139) there. For a CUDA tensor it launches
one of the routes of ``csrc/attention.cu`` (see the source note for what
bounds each and why it is shaped so) inside a ``torch.autograd.Function``
whose backward is ``attention_backward`` (below). For a CPU tensor it
returns ``attention_reference``, the same math in plain PyTorch. There is
no fallback: a CUDA tensor that no route takes raises, and so does a
failed build or launch.

``_route`` picks the route by geometry alone:

- ``"wgmma"`` (``attention_forward_tma``): bf16, D = 64, 64 <= Sq, Sk <=
  256, every base address and stride a positive multiple of 16 bytes (the
  tensor maps' rule). One pass over the keys with the whole row of scores
  in registers, TMA loads and stores, ``wgmma`` for both products,
  persistent blocks. The ViT (S=197) and RoBERTa (S=213) self-attentions
  take it, their head views included.
- ``"short_kv"`` (``attention_forward_short``): bf16, 1 <= Sq, Sk <= 64, D
  a multiple of 16, the same readable strides, outside the ``"wgmma"``
  domain. Every SGA call takes it (Sq=16, Sk=16 or 64, D=96, H=8, or 4 on
  a tp=2 rank), contiguous or as head views. It replaces the
  ``"mma_sync"`` route there: that route's one-warp blocks waited for
  their head's K and V before any product and took two passes over the
  keys. This one is bound by bytes and latency, so persistent blocks (one
  per SM) keep a ring of heads loading by TMA while 4 warps compute; the
  scores of 16 query rows over at most 64 keys stay in registers, so the
  softmax takes one pass, P normalised in fp32 before its rounding to
  bf16, as the reference rounds it. The maps have no swizzle and boxes 8
  columns wider than D, so the rows land padded in shared memory (no
  swizzle mode covers a 192-byte row). The products are ``mma.sync``:
  ``wgmma``'s 64 rows would be three quarters padding at Sq=16.
- ``"mma_sync"`` (``attention_forward``, bf16): every other bf16 call
  (more than 64 keys outside the ``"wgmma"`` domain, D not a multiple of
  16, strides a tensor map cannot read): ``mma.sync`` tiles of 16 query
  rows, two passes over the keys.
- ``"fp32"`` (``attention_forward``, float32): the check path, on CUDA
  cores.

The kernels read q, k and v in place: strided [B, H, S, D] views whose last
dimension is contiguous, such as the head split of a [B, S, H*D] projection,
as long as every row starts 16-byte aligned (contiguous tensors are always
taken). They write the output as a contiguous [B, Sq, H, D] tensor and
return the [B, H, Sq, D] view of it, so merging the heads back is a free
reshape.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernels, and ``route_launches`` splits them by route.

Where autograd will need the gradient (grad mode on and an input that
requires it) and the forward takes the ``"wgmma"`` route, the forward
kernel also writes each query row's statistics, as it formed P: the max of
the row's scores times log2(e) / sqrt(D), m, and the sum l of
2^(s log2(e) / sqrt(D) - m) (fp32 [B, H, Sq, 2], 1.3 MB at B=64, H=12,
S=213; ``attention_stats_reference`` is their plain version).
``_FusedAttention`` saves them, and the backward forms P = 2^(...) / l
from them: the forward's fp32 P, to the bit. ``stats_launches`` counts the
forwards that wrote statistics: a serving forward (``no_grad``,
``inference_mode``) writes none.

The backward (``attention_backward``, the counterpart of ``_fas_bwd`` at
:156 there) has two routes, picked by ``_bwd_route`` on the same geometry:

- ``"wgmma"`` (``attention_backward_tma`` in ``csrc/attention_bwd.cu``):
  wherever the forward takes the ``"wgmma"`` route. dQ, dK and dV in one
  kernel from the forward's row statistics, rounded where autograd of
  ``attention_reference`` rounds them (see the source note). The gradient
  is read in place when a tensor map can read it, as the [B, H, Sq, D]
  view of a contiguous [B, Sq, H, D] that the callers' head merge hands
  back; any other gradient is made contiguous first, and ``bwd_grad_copies`` counts those copies.
  dQ, dK and dV come back as [B, H, S, D] views of contiguous [B, S, H, D]
  tensors. Called without statistics (``stats=None``: a check or a timing
  of the backward alone), it has the forward kernel compute them first and
  counts that in ``bwd_stats_recomputed``; the main path's autograd
  backward never does.
- ``"plain"``: the VJP of ``attention_reference``, recomputed from q, k
  and v. Every other CUDA call takes it: the ``"short_kv"`` and
  ``"mma_sync"`` routes' calls, the SGA's among them (D=96, whose VJP runs
  only at dropout 0, since production SGA dropout takes the plain path
  both ways), and the fp32 check path.

``bwd_route_launches`` counts the CUDA backward passes by route; CPU
tensors take the plain VJP and count nothing.

Every ``fused_attention`` call is the profiler range ``op.attention``, and
the CUDA path of ``attention_backward`` the range ``op.attention_bwd``, on
the thread autograd runs it on (``utils/profiling.py``): they time the op
whatever route or kernel implements it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..utils.profiling import span
from . import kernel_build

launches = 0
route_launches = {"wgmma": 0, "short_kv": 0, "mma_sync": 0, "fp32": 0}
bwd_route_launches = {"wgmma": 0, "plain": 0}
bwd_grad_copies = 0
stats_launches = 0
bwd_stats_recomputed = 0

_MAX_SK = 256
_MAX_D = 128
_WARPS_F32 = 8
_MAX_SMEM = 232448          # H100: dynamic shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_D = 64                 # the wgmma route: one 128-byte swizzled row
_TMA_MIN_S, _TMA_MAX_S = 64, 256
_SHORT_MAX_S = 64           # the short_kv route: four 16-row tiles at most
_SYMBOLS = {"wgmma": "attention_forward_tma",
            "short_kv": "attention_forward_short",
            "mma_sync": "attention_forward", "fp32": "attention_forward"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])
# the wgmma route takes one more: the row statistics' buffer, or null
_ARGTYPES_TMA = _ARGTYPES + [ctypes.c_void_p]
_BWD_SYMBOL = "attention_backward_tma"
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])


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


def attention_stats_reference(q: torch.Tensor, k: torch.Tensor
                              ) -> torch.Tensor:
    """The row statistics the forward kernel writes for the backward, fp32
    [B, H, Sq, 2]: m, the max of each query row's scores times
    log2(e) / sqrt(D), and l, the sum of 2^(s log2(e) / sqrt(D) - m) over
    its keys."""
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores * (math.log2(math.e) / math.sqrt(q.shape[-1]))
        m = scores.amax(-1)
        return torch.stack((m, torch.exp2(scores - m[..., None]).sum(-1)), -1)


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


def _tma_readable(t: torch.Tensor) -> bool:
    """A tensor map can read ``t``'s [B, H, S, D] rows in place: D
    contiguous, the base address and the strides of b, h and s positive
    multiples of 16 bytes."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and (st * size) % 16 == 0
                    for st in t.stride()[:3]))


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes a call ``_check`` accepts, by geometry alone:
    ``"wgmma"``, ``"short_kv"``, ``"mma_sync"`` or ``"fp32"`` (see the
    module docstring)."""
    if q.dtype == torch.float32:
        return "fp32"
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    if not all(_tma_readable(t) for t in (q, k, v)):
        return "mma_sync"
    if (D == _TMA_D and _TMA_MIN_S <= Sq <= _TMA_MAX_S
            and _TMA_MIN_S <= Sk <= _TMA_MAX_S):
        return "wgmma"
    if 1 <= Sq <= _SHORT_MAX_S and Sk <= _SHORT_MAX_S and D % 16 == 0:
        return "short_kv"
    return "mma_sync"


def _forced_route(q, k, v, route: Optional[str]) -> str:
    """``route`` where the geometry admits it, else ``_route``'s choice when
    ``route`` is None; raises otherwise. ``"mma_sync"`` takes any bf16
    call, so that a check or a timing can hold the other bf16 routes
    against it."""
    chosen = _route(q, k, v)
    if route is not None and route != chosen and not (
            route == "mma_sync" and chosen in ("wgmma", "short_kv")):
        raise ValueError(f"route {route!r} does not take this call "
                         f"(dtype {q.dtype}, q {tuple(q.shape)}, strides "
                         f"{q.stride()}); its route is {chosen!r}")
    return route or chosen


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            route: Optional[str] = None, stats: bool = False):
    """Launch the kernel of ``_route(q, k, v)``, or the one ``route`` forces
    (``_forced_route``; the main path never passes it). With ``stats`` (the
    ``"wgmma"`` route only) it returns (out, stats): the rows' statistics,
    fp32 [B, H, Sq, 2], written by the same kernel."""
    global launches, stats_launches
    route = _forced_route(q, k, v, route)
    if stats and route != "wgmma":
        raise ValueError(f"only the wgmma route writes row statistics, "
                         f"not {route!r}")
    B, H, Sq, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Sq, k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], _DTYPES[q.dtype], stream]
    if route == "wgmma":
        fn = kernel_build.function("attention", _SYMBOLS[route],
                                   _ARGTYPES_TMA)
        row_stats = (torch.empty((B, H, Sq, 2), dtype=torch.float32,
                                 device=q.device) if stats else None)
        args.append(row_stats.data_ptr() if stats else None)
    else:
        fn = kernel_build.function("attention", _SYMBOLS[route], _ARGTYPES)
    kernel_build.check(fn(*args), _SYMBOLS[route])
    launches += 1
    route_launches[route] += 1
    if stats:
        stats_launches += 1
        return out.transpose(1, 2), row_stats
    return out.transpose(1, 2)


def _bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward's route for a call ``_check`` accepts, by geometry
    alone: ``"wgmma"`` where the forward takes the ``"wgmma"`` route, else
    ``"plain"`` (see the module docstring)."""
    return "wgmma" if _route(q, k, v) == "wgmma" else "plain"


def _forced_bwd_route(q, k, v, route: Optional[str]) -> str:
    """``route`` where the geometry admits it (``"plain"`` always), else
    ``_bwd_route``'s choice when ``route`` is None; raises otherwise."""
    chosen = _bwd_route(q, k, v)
    if route is not None and route not in (chosen, "plain"):
        raise ValueError(f"backward route {route!r} does not take this call "
                         f"(dtype {q.dtype}, q {tuple(q.shape)}, strides "
                         f"{q.stride()}); its route is {chosen!r}")
    return route or chosen


def _plain_vjp(q, k, v, g):
    """The VJP of ``attention_reference`` at (q, k, v), recomputed."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_reference(qq, kk, vv)
        return torch.autograd.grad(out, (qq, kk, vv), g)


def _readable_grad(g: torch.Tensor) -> torch.Tensor:
    """``g`` itself where a tensor map can read it, else a contiguous copy
    in a fresh, aligned buffer (counted in ``bwd_grad_copies``)."""
    global bwd_grad_copies
    if _tma_readable(g):
        return g
    bwd_grad_copies += 1
    return g.clone(memory_format=torch.contiguous_format)


def _launch_bwd(q, k, v, g, stats):
    """Launch the backward kernel with the rows' statistics ``stats`` (fp32
    [B, H, Sq, 2], as the forward wrote them): (dq, dk, dv) as
    [B, H, S, D] views of contiguous [B, S, H, D] tensors."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"the gradient must match the output: got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}, "
                         f"expected {tuple(q.shape)} {q.dtype} on {q.device}")
    if (stats.shape != (B, H, Sq, 2) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 [B, H, Sq, 2] "
                         f"on {q.device}, got {tuple(stats.shape)} "
                         f"{stats.dtype}")
    g = _readable_grad(g)
    fn = kernel_build.function("attention_bwd", _BWD_SYMBOL, _BWD_ARGTYPES)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, H, Sq, Sk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *g.stride()[:3], _DTYPES[q.dtype], stream)
    kernel_build.check(status, _BWD_SYMBOL)
    bwd_route_launches["wgmma"] += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, route: Optional[str] = None,
                       stats: Optional[torch.Tensor] = None):
    """(dq, dk, dv): the VJP of the attention at (q, k, v) for the output's
    gradient ``g``. CPU tensors: the plain VJP, uncounted (``stats``
    unused). CUDA tensors: the route of ``_bwd_route``; ``route="plain"``
    forces the plain VJP on any call, so that a check or a timing can hold
    the two against each other (the main path never passes it). The
    kernel's route takes the forward's row statistics ``stats``; without
    them it has the forward kernel compute them first (counted in
    ``bwd_stats_recomputed``). No fallback: a failed build or launch
    raises."""
    global bwd_stats_recomputed
    if q.device.type == "cpu":
        if route not in (None, "plain"):
            raise ValueError(f"CPU tensors take the plain VJP, not the "
                             f"{route!r} route")
        return _plain_vjp(q, k, v, g)
    with span("op.attention_bwd"):
        _check(q, k, v)
        if _forced_bwd_route(q, k, v, route) == "plain":
            bwd_route_launches["plain"] += 1
            return _plain_vjp(q, k, v, g)
        if stats is None:
            _, stats = _launch(q, k, v, stats=True)
            bwd_stats_recomputed += 1
        return _launch_bwd(q, k, v, g, stats)


def _saves_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The forward writes row statistics for its backward: CUDA tensors on
    the wgmma route, with grad mode on and an input that requires the
    gradient (not a serving forward)."""
    return (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))
            and _route(q, k, v) == "wgmma")


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, stats):
        if not stats:
            ctx.save_for_backward(q, k, v)
            return _launch(q, k, v)
        out, row_stats = _launch(q, k, v, stats=True)
        ctx.save_for_backward(q, k, v, row_stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, *row_stats = ctx.saved_tensors
        return (*attention_backward(q, k, v, g, stats=row_stats[0]
                                    if row_stats else None), None)


@span("op.attention")
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
    return _FusedAttention.apply(q, k, v, _saves_stats(q, k, v))
