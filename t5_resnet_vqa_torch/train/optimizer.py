"""Per-module learning-rate groups, the optimizers and the linear warmup
schedule.

PyTorch counterpart of the JAX package's ``train/optimizer.py``. There the
update is one optax chain: ``clip_by_global_norm`` before a per-group
``scale_by_amsgrad_torch`` -> ``add_decayed_weights(wd)`` ->
``scale_by_learning_rate(schedule)``, and ``set_to_zero`` for the frozen
modules. The same step in PyTorch is what that chain was written to match:
``torch.nn.utils.clip_grad_norm_`` over the trainable parameters, then
``torch.optim.AdamW(param_groups, weight_decay=wd, amsgrad=True)``, then a
``LambdaLR`` of the HF linear schedule (the JAX package's own golden test
builds this loop). Differences: ``clip_grad_norm_`` divides by the norm
plus 1e-6, optax by the norm; the tests' tolerances allow for it.

A parameter's group comes from the JAX top-level module its ``state_dict``
name stands for, through ``DEFAULT_GROUP_MAP``, as ``label_params`` labels
the JAX param tree by its top-level module. That module is the name's
first component, except under the prefixes of ``JAX_TOP_LEVEL``: the ViT
family's ``lang_model`` (HF ``T5ForConditionalGeneration``) holds what the
JAX model keeps as three top-level modules, ``shared``, ``lang_encoder``
and ``lang_decoder``; the Faster-RCNN tower's ``vision_model.fpn`` is JAX's
``fpn``. And the cross-attention family's layer lists
(``JAX_LAYER_LISTS``): layer ``i`` of ``roberta_encoder_layers`` is JAX's
``roberta_layer_{i}``, and of ``vit_encoder_layers`` its ``vit_layer_{i}``.
Neither name is in ``DEFAULT_GROUP_MAP``, so both train at ``default_lr``
(the frozen set is ``vit_embeddings`` and the ``vit_layer_{i}``, so a
fine-tuned ViT layer trains at ``default_lr`` too, its embedding at
``vision_lr``). Frozen modules are left out of the
optimizer entirely, and so are the parameters no forward uses (the unused
projection twin, the backbone's ``fc``): they never change.

The optimizer types are the JAX package's (``_base_transform``): AdamW and
Adam as above, and three written here as ``torch.optim.Optimizer``s on the
fp32 master weights, each the optax chain it stands for with optax's
defaults, under the same global-norm clip and ``LambdaLR`` schedule:

  * ``SGD``: ``optax.sgd(lr, momentum)``, a trace ``t = g + momentum * t``
    from zeros and ``p -= lr * t``; no weight decay, no dampening.
  * ``Lamb``: ``optax.lamb(lr, weight_decay=wd)``: Adam moments (b1 0.9, b2
    0.999, eps 1e-6 outside the root) with bias correction, plus ``wd * p``,
    scaled by the trust ratio ||p|| / ||update|| of each tensor (1 where
    either norm is 0).
  * ``Adafactor``: ``optax.adafactor(lr)``: the factored second moment
    (decay ``1 - t^-0.8``, eps 1e-30 added to the squared gradient) over
    the two largest dimensions of a tensor whose second-largest is at least
    128, a full one otherwise (and for every 1-D tensor); the update
    clipped to a block RMS of 1, times the LR, times the parameter's RMS
    (at least 1e-3).

Each keeps its ``step`` per parameter, as optax counts per update. Lamb's
norms and Adafactor's factoring are per tensor, which equals optax's per
leaf because the weight bridge maps each JAX leaf to one tensor, only
transposed; the factored estimate is symmetric in its two dimensions, so a
[out, in] weight or an OIHW convolution factors as its JAX kernel does.

Under a mesh's model axis (``tp``, ``parallel/tensor_parallel.py``) a
parameter may be a slice of its full tensor. Every reduction that optax
takes over the full leaf stays one over the full tensor: Lamb's ||p|| and
||update||, Adafactor's choice of factored dimensions (from the full
shape: the local one may pick others), its row and column means and the
update's and the parameter's RMS are summed over the model group and
divided by the full sizes. AdamW, Adam and SGD are elementwise.
``state_split_dim`` says how a state tensor follows its parameter's split,
for checkpoints in the single-device layout.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.optim import Optimizer

from ..core.config import LRSchedulerConfig, OptimizerConfig
from ..parallel.sharding import all_reduce_sum
from ..parallel.tensor_parallel import TensorParallel, tp_dim

# top-level module name -> LR group (the reference trainer's grouping)
DEFAULT_GROUP_MAP: Dict[str, str] = {
    "vision_model": "vision",
    "fpn": "vision",
    "vit_embeddings": "vision",
    "lang_model": "lm_encoder",
    "lang_encoder": "lm_encoder",
    "shared": "lm_encoder",
    "roberta_embeddings": "lm_encoder",
    "lang_decoder": "lm_decoder",
    "upscale_layer": "fusion",
    "downscale_layer": "fusion",
    "sga_modules": "fusion",
    "attention_pooler": "fusion",
    "fusing_layer": "fusion",
    "layer_norm": "fusion",
    "classification_layer": "classifier",
}

# port module path -> the JAX top-level module it stands for, where the two
# differ (the ViT family's one tied table, encoder and decoder)
JAX_TOP_LEVEL: Dict[str, str] = {
    "lang_model.shared": "shared",
    "lang_model.encoder": "lang_encoder",
    "lang_model.decoder": "lang_decoder",
    "vision_model.fpn": "fpn",
}

# port layer list -> the prefix of the JAX top-level module of its item i
JAX_LAYER_LISTS: Dict[str, str] = {
    "roberta_encoder_layers": "roberta_layer_",
    "vit_encoder_layers": "vit_layer_",
}

GROUPS = ("vision", "lm_encoder", "lm_decoder", "fusion", "classifier",
          "default")

# label of the parameters the optimizer leaves alone
FROZEN_LABEL = "frozen"


def linear_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                num_training_steps: int
                                ) -> Callable[[int], float]:
    """HF get_linear_schedule_with_warmup: ramp 0->lr over warmup, then
    linear decay to 0 at num_training_steps. ``step < warmup`` is strict,
    so warmup 0 has no zero-lr first step; with warmup > 0 step 0 has lr 0."""
    warmup = float(num_warmup_steps)
    total = float(num_training_steps)

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * (step / max(1.0, warmup))
        return base_lr * max(0.0, (total - step) / max(1.0, total - warmup))

    return schedule


class SGD(Optimizer):
    """``optax.sgd(lr, momentum)`` (see the module docstring)."""

    def __init__(self, params, lr: float, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["momentum_buffer"] = torch.zeros_like(p)
                state["step"] += 1
                trace = state["momentum_buffer"]
                trace.mul_(group["momentum"]).add_(p.grad)
                p.sub_(group["lr"] * trace)


class Lamb(Optimizer):
    """``optax.lamb(lr, weight_decay=wd)`` (see the module docstring)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0,
                 tp: Optional[TensorParallel] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.tp = tp

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = float(state["step"])
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                update = (mu / (1 - b1 ** t)) / (
                    (nu / (1 - b2 ** t)).sqrt() + group["eps"])
                if group["weight_decay"]:
                    update.add_(p, alpha=group["weight_decay"])
                # square-sum-root: the CPU's norm() of a large fp32 tensor
                # is off by ~1e-3 (24.7M elements), its sum is not
                full = _Full(p, self.tp)
                p_norm, u_norm = full.l2(p), full.l2(update)
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                p.sub_(group["lr"] * ratio * update)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x.square().sum().sqrt()


class _Full:
    """Reductions over the full tensor behind ``p``, which a mesh's model
    axis may have split (``tp_dim``); without a split, the tensor's own."""

    def __init__(self, p: torch.Tensor, tp: Optional[TensorParallel]):
        self.dim = tp_dim(p) if tp is not None else None
        self.tp = tp
        shape = list(p.shape)
        if self.dim is not None:
            shape[self.dim] *= tp.size
        self.shape = tuple(shape)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x, self.tp.group)

    def l2(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return _l2(x)
        return self._sum(x.square().sum()).sqrt()

    def rms(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return _rms(x)
        n = float(np.prod(self.shape))
        return (self._sum(x.square().sum()) / n).sqrt()

    def mean(self, x: torch.Tensor, dim: int,
             split: Optional[int]) -> torch.Tensor:
        """``x.mean(dim)`` of the full tensor, where ``x``'s dimension
        ``split`` is the split one (None: ``x`` is whole)."""
        if split is None or dim != split:
            return x.mean(dim)
        return self._sum(x.sum(dim)) / (x.shape[dim] * self.tp.size)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """(second-largest dim, largest dim), or None where the tensor is
    1-D or its second-largest dimension is under the minimum (optax's
    ``_factored_dims``, ties in dimension order)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


class Adafactor(Optimizer):
    """``optax.adafactor(lr)`` (see the module docstring)."""

    def __init__(self, params, lr: float, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3, eps: float = 1e-30,
                 tp: Optional[TensorParallel] = None):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, clipping_threshold=clipping_threshold,
            min_scale=min_scale, eps=eps))
        self.tp = tp

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                full = _Full(p, self.tp)
                dims = _factored_dims(full.shape,
                                      group["min_dim_size_to_factor"])
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        state["v_row"] = torch.zeros_like(p.select(d0, 0))
                        state["v_col"] = torch.zeros_like(p.select(d1, 0))
                state["step"] += 1
                decay = 1.0 - float(state["step"]) ** -group["decay_rate"]
                g_sq = g * g + group["eps"]
                if dims is None:
                    v = state["v"]
                    v.mul_(decay).add_(g_sq, alpha=1 - decay)
                    update = g * v.pow(-0.5)
                else:
                    d1, d0 = dims
                    s = full.dim
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.mul_(decay).add_(full.mean(g_sq, d0, s),
                                           alpha=1 - decay)
                    v_col.mul_(decay).add_(full.mean(g_sq, d1, s),
                                           alpha=1 - decay)
                    # v_row lacks dimension d0: d1 and the split move down
                    row_dim = d1 - 1 if d1 > d0 else d1
                    row_split = (None if s is None or s == d0
                                 else s - 1 if s > d0 else s)
                    row_mean = full.mean(v_row, row_dim,
                                         row_split).unsqueeze(row_dim)
                    row_factor = (v_row / row_mean).pow(-0.5)
                    col_factor = v_col.pow(-0.5)
                    update = (g * row_factor.unsqueeze(d0)
                              * col_factor.unsqueeze(d1))
                update = update / torch.clamp(
                    full.rms(update) / group["clipping_threshold"], min=1.0)
                update = update * group["lr"]
                p_rms = full.rms(p)
                update = update * torch.where(
                    p_rms <= group["min_scale"],
                    torch.full_like(p_rms, group["min_scale"]), p_rms)
                p.sub_(update)


OPTIMIZER_TYPES = ("AdamW", "Adam", "SGD", "Lamb", "Adafactor")

# state entries shaped as their parameter (AdamW/Adam, SGD, Lamb, an
# unfactored Adafactor)
_ELEMENTWISE_STATE = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq",
                      "momentum_buffer", "v")


def state_split_dim(optimizer: Optimizer, p: torch.Tensor, key: str,
                    tp_size: int) -> Optional[int]:
    """The dimension on which the state entry ``key`` of ``p`` is split when
    ``p`` is (``tp_dim``), or None where it is whole: an elementwise entry
    follows ``p``; Adafactor's ``v_row`` lacks the largest dimension and
    ``v_col`` the second-largest of the full shape, and each is split where
    it keeps ``p``'s split dimension."""
    s = tp_dim(p)
    if s is None or key == "step":
        return None
    if key in _ELEMENTWISE_STATE:
        return s
    if key in ("v_row", "v_col"):
        shape = list(p.shape)
        shape[s] *= tp_size
        group = next(g for g in optimizer.param_groups
                     if any(q is p for q in g["params"]))
        d1, d0 = _factored_dims(shape, group["min_dim_size_to_factor"])
        gone = d0 if key == "v_row" else d1
        return None if s == gone else s - 1 if s > gone else s
    raise ValueError(f"no split rule for optimizer state {key!r}")


def _make_optimizer(opt_type: str, param_groups, kwargs,
                    tp: Optional[TensorParallel] = None) -> Optimizer:
    """The optimizer of ``opt_type`` with the JAX package's arguments from
    ``optimizer_kwargs.kwargs``."""
    wd = kwargs.get("weight_decay", 0.0)
    amsgrad = kwargs.get("amsgrad", False)
    if opt_type == "AdamW":
        return torch.optim.AdamW(param_groups, weight_decay=wd,
                                 amsgrad=amsgrad)
    if opt_type == "Adam":     # no decay term, as the JAX chain for "Adam"
        return torch.optim.Adam(param_groups, amsgrad=amsgrad)
    if opt_type == "SGD":
        return SGD(param_groups, lr=0.0,
                   momentum=kwargs.get("momentum", 0.0))
    if opt_type == "Lamb":
        return Lamb(param_groups, lr=0.0, weight_decay=wd, tp=tp)
    if opt_type == "Adafactor":
        return Adafactor(param_groups, lr=0.0, tp=tp)
    raise ValueError(f"unsupported optimizer type {opt_type!r}")


def _group_lrs(opt_cfg: OptimizerConfig) -> Dict[str, float]:
    return {
        "vision": opt_cfg.vision_lr,
        "lm_encoder": opt_cfg.lm_encoder_lr,
        "lm_decoder": opt_cfg.lm_decoder_lr,
        "fusion": opt_cfg.fusion_lr,
        "classifier": opt_cfg.classifier_lr,
        "default": opt_cfg.default_lr,
    }


def unused_parameters(model: nn.Module) -> Tuple[str, ...]:
    """Names of parameters that no forward reads: the projection twin the
    model holds only for strict loading, and the backbone's ``fc``."""
    names = []
    projection = getattr(model, "projection", None)
    for twin in ("upscale_layer", "downscale_layer"):
        module = getattr(model, twin, None)
        if module is not None and projection is not None \
                and module is not projection:
            names += [f"{twin}.{n}" for n, _ in module.named_parameters()]
    vision = getattr(model, "vision_model", None)
    if vision is not None and getattr(vision, "fc", None) is not None:
        names += [f"vision_model.fc.{n}"
                  for n, _ in vision.fc.named_parameters()]
    return tuple(names)


def jax_top_level(name: str) -> str:
    """The JAX top-level module that the parameter ``name`` belongs to."""
    for prefix, top in JAX_TOP_LEVEL.items():
        if name.startswith(prefix + "."):
            return top
    parts = name.split(".")
    if parts[0] in JAX_LAYER_LISTS:
        return JAX_LAYER_LISTS[parts[0]] + parts[1]
    return parts[0]


def label_params(model: nn.Module,
                 group_map: Optional[Dict[str, str]] = None,
                 frozen_modules: Sequence[str] = ()) -> Dict[str, str]:
    """{parameter name: LR group}: the group of its JAX top-level module;
    FROZEN_LABEL for frozen modules and unused parameters. A tied table is
    one parameter and gets one label."""
    gm = group_map or DEFAULT_GROUP_MAP
    frozen = set(frozen_modules)
    unused = set(unused_parameters(model))
    labels = {}
    for name, _ in model.named_parameters():
        top = jax_top_level(name)
        labels[name] = (FROZEN_LABEL if top in frozen or name in unused
                        else gm.get(top, "default"))
    return labels


def build_optimizer(
    model: nn.Module,
    opt_cfg: OptimizerConfig,
    sched_cfg: LRSchedulerConfig,
    num_training_steps: int,
    group_map: Optional[Dict[str, str]] = None,
    frozen_modules: Sequence[str] = (),
    tp: Optional[TensorParallel] = None,
):
    """Returns (optimizer, scheduler, schedules_by_group, trainable params).

    One param group per LR group that has parameters, in ``GROUPS`` order,
    each named by its ``"group"`` key. ``schedules_by_group`` gives each
    group's LR at a step, for the step logs. ``tp``: the model axis of a
    mesh whose ``shard_model_`` split the model."""
    if opt_cfg.type not in OPTIMIZER_TYPES:
        raise ValueError(f"unsupported optimizer type {opt_cfg.type!r}")
    warmup = sched_cfg.resolve_warmup(num_training_steps)
    lrs = _group_lrs(opt_cfg)
    schedules = {g: linear_schedule_with_warmup(lr, warmup,
                                                num_training_steps)
                 for g, lr in lrs.items()}
    labels = label_params(model, group_map, frozen_modules)
    by_group: Dict[str, List[torch.Tensor]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if labels[name] != FROZEN_LABEL:
            by_group[labels[name]].append(p)
    param_groups = [{"params": ps, "lr": lrs[g], "group": g}
                    for g, ps in by_group.items() if ps]
    optimizer = _make_optimizer(opt_cfg.type, param_groups,
                                dict(opt_cfg.kwargs), tp)
    unit = linear_schedule_with_warmup(1.0, warmup, num_training_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, unit)
    trainable = [p for g in param_groups for p in g["params"]]
    return optimizer, scheduler, schedules, trainable
