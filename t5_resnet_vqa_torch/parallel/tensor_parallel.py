"""Megatron tensor parallelism over the mesh's model axis.

What GSPMD derives in the JAX package from the specs of
``parallel/sharding.py`` is written out here:

  * ``copy_to_tp`` (identity forward, all-reduce of the gradient over the
    ``tp`` group backward) in front of every column-parallel linear, and
    ``reduce_from_tp`` (all-reduce forward, identity backward) behind every
    row-parallel one. Both are ``torch.autograd.Function``s of their own:
    ``torch.distributed.nn.functional.all_reduce`` also all-reduces the
    gradient backward, which would multiply every replicated gradient by tp.
  * A row-parallel bias is added once, after the all-reduce.
  * ``slice_replicated``: a replicated tensor read in slices (T5's
    ``relative_attention_bias`` [buckets, H], of which each rank reads its
    heads' columns): forward the slice, backward the gradient of the whole
    tensor summed over the group, so that the replicated parameter gets the
    single-device gradient on every rank.
  * ``MeshDropout``: as the JAX package's one dropout key does for the
    logical tensor, every rank draws the mask of the full tensor (the
    global batch on dim 0; the full heads or width where the model axis
    splits it) from the generator all ranks seed alike, and keeps its own
    block. The replicas of a model group so draw the same mask for a
    replicated activation and stay equal to the bit, the data axis's ranks
    draw the masks of their own rows, and the generators stay in step. The
    mask is drawn as the CPU's ``F.dropout`` draws it, so that a mesh of CPU
    ranks drops what the single-device run drops. The kept block is copied
    out, so that backward holds the rank's block, not the full mask; the
    draw itself is the full tensor's on every rank.

``shard_model_`` applies all of it to a model in place: it slices the
weights of the column- and row-parallel ``nn.Linear``s (``COL_PARALLEL`` /
``ROW_PARALLEL`` by name), which also sets the head count of every
attention (the modules take it from the projections' width), and puts a
``MeshDropout`` in the place of every dropout. Heads or widths that do not
divide by tp raise ``ValueError`` naming the module (GSPMD would pad
them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .sharding import (
    Mesh,
    all_reduce_sum,
    param_partition_spec,
    split_dim,
)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place on the model axis: its group, its index and tp."""
    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, mesh: Optional[Mesh]) -> Optional["TensorParallel"]:
        """None without a mesh or with tp = 1."""
        if mesh is None or mesh.model == 1:
            return None
        return cls(mesh.tp_group, mesh.model_index, mesh.model)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, start, length, group):
        ctx.args = (w.shape, dim, start, length, group)
        return w.narrow(dim, start, length).clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dim, start, length, group = ctx.args
        full = grad.new_zeros(shape)
        full.narrow(dim, start, length).copy_(grad)
        return all_reduce_sum(full, group), None, None, None, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp.group)


def slice_replicated(w: torch.Tensor, dim: int, tp: TensorParallel
                     ) -> torch.Tensor:
    """This rank's 1/tp of the replicated ``w`` along ``dim``."""
    n = w.shape[dim] // tp.size
    return _SliceReplicated.apply(w, dim, tp.rank * n, n, tp.group)


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of an ``nn.Linear`` (keys ``weight``,
    ``bias``)."""

    def __init__(self, linear: nn.Linear, tp: TensorParallel):
        super().__init__()
        self.tp = tp
        self.weight = _shard_param(linear.weight, 0, tp)
        self.bias = (None if linear.bias is None
                     else _shard_param(linear.bias, 0, tp))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to_tp(x, self.tp), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's input columns of an ``nn.Linear``; the partial products
    are summed over the group, then the (replicated) bias is added once."""

    def __init__(self, linear: nn.Linear, tp: TensorParallel):
        super().__init__()
        self.tp = tp
        self.weight = _shard_param(linear.weight, 1, tp)
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = reduce_from_tp(F.linear(x, self.weight), self.tp)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class MeshDropout(nn.Module):
    """Dropout of one mesh rank (see the module docstring); ``dim`` is the
    dimension the model axis splits, or None."""

    def __init__(self, p: float, mesh: Mesh, dim: Optional[int] = None):
        super().__init__()
        self.p, self.mesh = p, mesh
        self.dim = dim if mesh.model > 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        mesh = self.mesh
        shape = list(x.shape)
        shape[0] *= mesh.data
        if self.dim is not None:
            shape[self.dim] *= mesh.model
        full = torch.empty(shape, dtype=x.dtype,
                           device=x.device).bernoulli_(1.0 - self.p)
        noise = full.narrow(0, mesh.data_index * x.shape[0], x.shape[0])
        if self.dim is not None:
            n = x.shape[self.dim]
            noise = noise.narrow(self.dim, mesh.model_index * n, n)
        if noise.numel() != full.numel():
            # backward keeps this block alive, not the full mask
            noise = noise.clone()
        return x * noise.div_(1.0 - self.p)


def _shard_param(p: nn.Parameter, dim: int, tp: TensorParallel
                 ) -> nn.Parameter:
    n = p.shape[dim] // tp.size
    out = nn.Parameter(p.detach().narrow(dim, tp.rank * n, n).clone(),
                       requires_grad=p.requires_grad)
    out.tp_dim = dim
    return out


def tp_dim(p: torch.Tensor) -> Optional[int]:
    """The dimension ``shard_model_`` split ``p`` on, or None."""
    return getattr(p, "tp_dim", None)


def _check_divides(what: str, name: str, value: int, tp: int) -> None:
    if value % tp:
        raise ValueError(f"{name}: {what} {value} does not divide over the "
                         f"model axis ({tp}); the port does not pad")


def _heads(module: nn.Module) -> Optional[int]:
    """The head count of an attention module of the port, or None."""
    from ..models.roberta import RobertaLayer
    from ..models.t5 import T5Attention
    from ..models.vit import ViTSelfAttention
    from ..ops.layers import MultiHeadAttention
    if isinstance(module, (T5Attention, MultiHeadAttention, ViTSelfAttention,
                           RobertaLayer)):
        return module.config.num_heads
    return None


def shard_model_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split ``model`` over ``mesh`` in place (see the module docstring):
    its dropouts for the mesh, and, with tp > 1, its weights over the model
    axis. Run it on the full (single-device) weights, the same on every
    rank."""
    from ..models.t5 import T5Attention, T5DenseReluDense
    from ..ops.layers import MLP, MultiHeadAttention
    tp = TensorParallel.of(mesh)
    # the dimension the model axis splits, by the module that drops
    split = {}
    for name, module in model.named_modules():
        heads = _heads(module)
        if heads is not None and tp is not None:
            _check_divides("heads", name, heads, tp.size)
        if isinstance(module, T5Attention):
            module.tp = tp
            split[id(module.dropout)] = 1
        elif isinstance(module, MultiHeadAttention):
            module.head_dropout = MeshDropout(
                module.config.dropout_rate, mesh, 1).train(module.training)
        elif isinstance(module, (T5DenseReluDense, MLP)):
            split[id(module.dropout)] = -1
    for module in list(model.modules()):
        for child_name, child in list(module.named_children()):
            if isinstance(child, nn.Dropout):
                setattr(module, child_name, MeshDropout(
                    child.p, mesh, split.get(id(child))).train(child.training))
    if tp is None:
        return model
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            if not isinstance(child, nn.Linear):
                continue
            full = f"{name}.{child_name}" if name else child_name
            dim = split_dim(param_partition_spec(full + ".weight",
                                                 child.weight))
            if dim is None:
                continue
            _check_divides("width", full, child.weight.shape[dim], tp.size)
            cls = ColumnParallelLinear if dim == 0 else RowParallelLinear
            setattr(module, child_name, cls(child, tp))
    return model


def sharded_sq_norm(params, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The squared L2 norm of the full tensors behind ``params``' gradients:
    split ones summed over the model group, replicated ones counted once."""
    split, whole = [], []
    for p in params:
        if p.grad is not None:
            (split if tp is not None and tp_dim(p) is not None
             else whole).append(p.grad.detach().float().square().sum())
    device = next(iter(params)).device
    total = torch.zeros((), device=device)
    if split:
        total = total + all_reduce_sum(torch.stack(split).sum(), tp.group)
    if whole:
        total = total + torch.stack(whole).sum()
    return total


def clip_grad_norm_(params, max_norm: float,
                    tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over the full tensors: without tp
    it is that function; with tp the norm counts each split gradient's
    slices over the group and each replicated one once, and the scale (max
    norm over the norm plus 1e-6, at most 1) is torch's."""
    params = [p for p in params if p.grad is not None]
    if tp is None:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    norm = sharded_sq_norm(params, tp).sqrt()
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for p in params:
        p.grad.detach().mul_(scale.to(p.grad.dtype))
    return norm
