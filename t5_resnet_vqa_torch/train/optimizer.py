"""Per-module learning-rate groups, AdamW and the linear warmup schedule.

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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import LRSchedulerConfig, OptimizerConfig

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
):
    """Returns (optimizer, scheduler, schedules_by_group, trainable params).

    One param group per LR group that has parameters, in ``GROUPS`` order,
    each named by its ``"group"`` key. ``schedules_by_group`` gives each
    group's LR at a step, for the step logs."""
    kwargs = dict(opt_cfg.kwargs)
    wd = kwargs.get("weight_decay", 0.0)
    amsgrad = kwargs.get("amsgrad", False)
    if opt_cfg.type not in ("AdamW", "Adam"):
        raise NotImplementedError(
            f"optimizer type {opt_cfg.type!r} is not ported; the port "
            f"trains with AdamW or Adam")

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
    if opt_cfg.type == "AdamW":
        optimizer = torch.optim.AdamW(param_groups, weight_decay=wd,
                                      amsgrad=amsgrad)
    else:                # Adam: no decay term, as the JAX chain for "Adam"
        optimizer = torch.optim.Adam(param_groups, amsgrad=amsgrad)
    unit = linear_schedule_with_warmup(1.0, warmup, num_training_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, unit)
    trainable = [p for g in param_groups for p in g["params"]]
    return optimizer, scheduler, schedules, trainable
