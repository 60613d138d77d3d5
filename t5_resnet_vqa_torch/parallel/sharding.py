"""The (data, model) mesh and its sharding rules.

PyTorch counterpart of the JAX package's ``parallel/sharding.py``. There one
process drives a 2-axis ``jax.sharding.Mesh`` and GSPMD inserts the
collectives; here each rank is a process of its own (``parallel/launch.py``
starts them) and the mesh is a set of ``torch.distributed`` process groups:

  * ``Mesh`` lays the ranks out in JAX's grid order, rank = d * tp + m
    (``make_mesh``'s ``reshape(data, model)``), so that the ranks of one
    model group are consecutive. It holds one ``dp`` group per model index
    (the data axis: DDP all-reduces gradients over it) and one ``tp`` group
    per data index (the model axis: Megatron tensor parallelism,
    ``parallel/tensor_parallel.py``), and a gloo group over the mesh for
    host objects.
  * ``param_partition_spec`` is JAX's rule on the port's parameter names
    (the reference's ``state_dict`` keys), in the torch layout: a flax
    kernel is [in, out] and an ``nn.Linear`` weight [out, in], so JAX's
    column-parallel ``P(None, "model")`` splits dim 0 here and its
    row-parallel ``P("model", None)`` dim 1. Column-parallel biases split;
    everything else is replicated.
  * ``shard_state_dict`` / ``gather_state_dict`` convert between the full
    (single-device) state dict and a rank's own.
  * A rank takes the contiguous rows ``[d * B / dp, (d + 1) * B / dp)`` of a
    global batch (``batch_rows``), which is what ``P("data")`` gives. A
    ``DistributedSampler`` would interleave the rows instead and change
    which samples form a step.

The collectives that move tensors go through the helpers at the end of
this module, which NCCL and gloo share. gloo on CUDA tensors has only
``broadcast``, ``all_reduce`` and ``barrier``, so a gather is an all-reduce
of the bytes into a zeroed buffer (exact: every byte is summed with zeros),
and a bf16 or fp16 sum is taken in fp32 on every backend (one rounding, the
same result under NCCL and gloo).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# module names that are column-parallel (weight dim 0 = out split) ...
COL_PARALLEL = frozenset({
    "q", "k", "v", "wi",                      # T5
    "query", "key", "value", "intermediate",  # ViT / RoBERTa
    "linear_q", "linear_k", "linear_v", "fc1",  # SGA
})
# ... and row-parallel (weight dim 1 = in split), as in the JAX package
ROW_PARALLEL = frozenset({
    "o", "wo",                                # T5
    "out", "output",                          # ViT / RoBERTa
    "linear_merge", "fc2", "attention_output",  # SGA
})

# a spec names the mesh axis of each dimension (None: not split); () is
# replicated, as JAX's P()
Spec = Tuple[Optional[str], ...]


def _module_name(name: str) -> Optional[str]:
    """The module a parameter belongs to, under JAX's naming: the component
    before the leaf, or before HF's ``dense`` wrapper (the port's
    ``intermediate.dense`` is JAX's ``intermediate``)."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    if parts[-2] == "dense" and len(parts) >= 3:
        return parts[-3]
    return parts[-2]


def param_partition_spec(name: str, tensor: torch.Tensor) -> Spec:
    """JAX's Megatron spec of the leaf the port's ``name`` stands for, in the
    torch layout (see the module docstring)."""
    module, leaf = _module_name(name), name.split(".")[-1]
    if leaf == "weight" and tensor.dim() == 2:
        if module in COL_PARALLEL:
            return (MODEL_AXIS, None)
        if module in ROW_PARALLEL:
            return (None, MODEL_AXIS)
    if leaf == "bias" and tensor.dim() == 1 and module in COL_PARALLEL:
        return (MODEL_AXIS,)
    return ()


def split_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec splits over the model axis, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


@dataclasses.dataclass
class Mesh:
    """One rank's view of the (data, model) mesh (see the module docstring).

    ``rank`` is the rank in the default group, None for a rank outside the
    mesh (a mesh smaller than the world, as JAX's ``devices[:use]``)."""
    data: int
    model: int
    rank: Optional[int]
    device: torch.device
    mesh_group: Any = None
    dp_group: Any = None
    tp_group: Any = None
    host_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def member(self) -> bool:
        return self.rank is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes logs and checkpoints."""
        return self.rank == 0

    def batch_rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.data:
            raise ValueError(
                f"batch {batch_size} must divide evenly over the mesh data "
                f"axis ({self.data} ways)")
        n = batch_size // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)


def make_mesh(data_axis_size: int = -1, model_axis_size: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the first ``data * model`` ranks of the default group,
    with JAX's rules: -1 means all remaining ranks, and an indivisible count
    raises ``ValueError``. Every rank of the default group calls it (group
    creation is collective); a rank outside the mesh gets ``rank=None``.
    ``device`` defaults to the one the launcher gave this rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (parallel/launch.py starts one per rank)")
    n = dist.get_world_size()
    if model_axis_size < 1:
        raise ValueError(f"model axis {model_axis_size} must be >= 1")
    if data_axis_size == -1:
        if n % model_axis_size:
            raise ValueError(f"{n} devices not divisible by model axis "
                             f"{model_axis_size}")
        data_axis_size = n // model_axis_size
    if data_axis_size < 1:
        raise ValueError(f"data axis {data_axis_size} must be >= 1 or -1")
    use = data_axis_size * model_axis_size
    if use > n:
        raise ValueError(
            f"cannot reshape {n} devices into a ({data_axis_size}, "
            f"{model_axis_size}) mesh")
    rank = dist.get_rank()
    if device is None:
        from .launch import current_device
        device = current_device()
    mesh = Mesh(data_axis_size, model_axis_size,
                rank if rank < use else None, device)
    grid = np.arange(use).reshape(data_axis_size, model_axis_size)
    # every rank creates every group, in one order
    mesh.mesh_group = (dist.group.WORLD if use == n
                       else dist.new_group(list(range(use))))
    for d in range(data_axis_size):
        g = dist.new_group(grid[d].tolist())
        if mesh.member and mesh.data_index == d:
            mesh.tp_group = g
    for m in range(model_axis_size):
        g = dist.new_group(grid[:, m].tolist())
        if mesh.member and mesh.model_index == m:
            mesh.dp_group = g
    mesh.host_group = (mesh.mesh_group if dist.get_backend() == "gloo"
                       else dist.new_group(list(range(use)), backend="gloo"))
    return mesh


# ------------------------------------------------------------ state dicts

def shard_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh
                 ) -> torch.Tensor:
    """This rank's slice of a full tensor split on ``dim`` (None: whole)."""
    if dim is None or mesh.model == 1:
        return t
    if t.shape[dim] % mesh.model:
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} tensor does "
                         f"not divide over the model axis ({mesh.model})")
    return t.chunk(mesh.model, dim)[mesh.model_index].clone()


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict -> this rank's, by ``param_partition_spec``."""
    return {k: shard_tensor(v, split_dim(param_partition_spec(k, v)), mesh)
            for k, v in full.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], mesh: Mesh
                      ) -> Dict[str, torch.Tensor]:
    """This rank's state dict -> the full one, on every rank of its model
    group (a collective over it). Tied entries stay one tensor."""
    full: Dict[str, torch.Tensor] = {}
    done: Dict[int, torch.Tensor] = {}
    for k, v in local.items():
        if id(v) in done:
            full[k] = done[id(v)]
            continue
        # the spec of a local tensor is the spec of its full name
        dim = split_dim(param_partition_spec(k, v))
        out = (all_gather_cat(v, mesh.tp_group, dim, mesh.model)
               if dim is not None and mesh.model > 1 else v)
        full[k] = done[id(v)] = out
    return full


# ------------------------------------------------------------ collectives

_WIDEN = (torch.bfloat16, torch.float16)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over ``group``; bf16 and fp16 are
    summed in fp32 and rounded once."""
    out = (t.float() if t.dtype in _WIDEN else t.clone()).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def all_gather_cat(t: torch.Tensor, group, dim: int, size: int
                   ) -> torch.Tensor:
    """The ``group`` members' tensors concatenated on ``dim`` in group-rank
    order, on every member, to the bit: each member writes its part into a
    zeroed buffer and the buffers' bytes are summed."""
    t = t.contiguous()
    shape = list(t.shape)
    shape[dim] *= size
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    n = t.shape[dim]
    buf.narrow(dim, dist.get_rank(group) * n, n).copy_(t)
    dist.all_reduce(buf.view(-1).view(torch.uint8), group=group)
    return buf


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch-sharded tensor -> the global batch, on
    every rank (a collective over the data axis)."""
    if mesh.data == 1:
        return t
    return all_gather_cat(t, mesh.dp_group, 0, mesh.data)


def mean_over_data(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``t`` over the data axis (each rank's row means of equal
    shards: the global mean)."""
    if mesh.data == 1:
        return t
    return all_reduce_sum(t, mesh.dp_group) / mesh.data


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's ``obj`` on every rank of the mesh (over the gloo group)."""
    box: List[Any] = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


def ranks_on_host(mesh: Mesh) -> int:
    """How many ranks of the mesh run on this rank's host (a collective over
    the mesh)."""
    import socket
    names: List[Any] = [None] * (mesh.data * mesh.model)
    dist.all_gather_object(names, socket.gethostname(),
                           group=mesh.host_group)
    return names.count(socket.gethostname())


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a host batch: every array with the batch's
    leading dimension is sliced, the rest (host records, ``_valid``) is
    kept. The full labels stay under ``_batch_annotation_ids``."""
    n = len(batch["annotation_ids"])
    rows = mesh.batch_rows(n)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == n \
                and v.dtype != object:
            out[k] = v[rows]
        else:
            out[k] = v
    out["_batch_annotation_ids"] = np.asarray(batch["annotation_ids"])
    return out


class ShardedLoader:
    """Wrap a ``DataLoader``: each batch as this rank's rows
    (``shard_batch``)."""

    def __init__(self, loader, mesh: Mesh):
        self.loader = loader
        self.mesh = mesh
        mesh.batch_rows(loader.batch_size)      # raises if it does not divide

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        for batch in self.loader:
            yield shard_batch(batch, self.mesh)
