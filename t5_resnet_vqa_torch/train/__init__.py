"""Training: optimizer groups and schedule, callbacks, model factory, the
frozen-feature cache and the trainer (``python -m t5_resnet_vqa_torch.train``
for the CNN family, ``python -m t5_resnet_vqa_torch.train.vit`` for the ViT
family)."""

from .callbacks import Callbacks, EarlyStopping
from .factory import build_model, model_family
from .feature_cache import (
    CachedFeatureLoader,
    FrozenFeatureCache,
    build_feature_cache,
    collect_image_slots,
)
from .optimizer import build_optimizer, label_params, linear_schedule_with_warmup
from .trainer import VQATrainer, make_eval_step, make_train_step

__all__ = [
    "CachedFeatureLoader", "Callbacks", "EarlyStopping", "FrozenFeatureCache",
    "VQATrainer", "build_feature_cache", "build_model", "build_optimizer",
    "collect_image_slots", "label_params", "linear_schedule_with_warmup",
    "make_eval_step", "make_train_step", "model_family",
]
