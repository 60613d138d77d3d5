"""Training: optimizer groups and schedule, callbacks, model factory and the
trainer (``python -m t5_resnet_vqa_torch.train``)."""

from .callbacks import Callbacks, EarlyStopping
from .factory import build_model, model_family
from .optimizer import build_optimizer, label_params, linear_schedule_with_warmup
from .trainer import VQATrainer, make_eval_step, make_train_step

__all__ = [
    "Callbacks", "EarlyStopping", "VQATrainer", "build_model",
    "build_optimizer", "label_params", "linear_schedule_with_warmup",
    "make_eval_step", "make_train_step", "model_family",
]
