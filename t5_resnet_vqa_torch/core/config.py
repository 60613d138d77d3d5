"""Config system: the six-group JSON file of the reference, typed.

A copy of the JAX package's ``core/config.py`` (the port imports nothing
from that package). The groups and key names are the reference's
(``vit_daquar_config.json``), so a reference config file loads unchanged;
every field of the JAX package is kept, with its default, so that
``Config.to_dict()`` gives the same dictionary for the same file. Dotted
overrides (``--set trainer_kwargs.epochs=3``) work as there.

A few fields steer parts of the JAX package that change no number in the
port (``steps_per_dispatch``, ``fast_dropout_rng``, ``use_pallas``,
``use_wandb``); the trainer (``train/trainer.py``) names them in one log
line.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only keys the dataclass knows; '_description' etc. are dropped."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class ModelConfig:
    """model_kwargs group."""
    vision_model_name: str = "resnet50"
    language_model_name: str = "t5-base"
    device: str = "tpu"                  # accepted for parity; unused
    num_attention_blocks: int = 3        # SGA depth
    fine_tune_lm_encoder: bool = True
    fine_tune_lm_decoder: bool = True
    fine_tune_vision: bool = False       # the reference trains a frozen tower
    compute_dtype: str = "float32"       # "bfloat16": bf16 compute
    use_pallas: bool = False             # the JAX package's kernel switch
    fused_qkv: bool = False              # a JAX-side layout choice, same math
    temperature_scaler: float = 1.0      # logits / T before the softmax

    VISION_CHOICES = (
        "resnet18", "resnet34", "resnet50", "faster-rcnn",
        "google/vit-base-patch16-224-in21k",
    )

    def validate(self) -> None:
        if self.vision_model_name not in self.VISION_CHOICES:
            raise ValueError(
                f"vision_model_name={self.vision_model_name!r} not in "
                f"{self.VISION_CHOICES}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype {self.compute_dtype!r}")


@dataclass
class DatasetConfig:
    """dataset_kwargs group."""
    root_data_dir: str = "DAQUAR_dataset"
    train_csv_file: str = "train.csv"
    test_csv_file: str = "test.csv"
    answer_spaces_file: str = "answer_spaces.txt"
    images_dir: str = "images"
    image_preprocessor_model: str = "google/vit-base-patch16-224-in21k"
    language_model_tokenizer: str = "t5-base"
    tokenizer_file: str = ""             # a user-supplied HF tokenizer.json
    train_batch_size: int = 4
    test_batch_size: int = 16
    interpolation_strategy: str = "bilinear_interpolation"
    image_size: int = 256               # CNN-family resize target
    num_prefetch_batches: int = 2
    num_workers: int = 0
    use_native_preprocessor: bool = True  # the JAX package's C++ resize
    drop_remainder: bool = True           # train batches: drop the last one
    uint8_wire_images: bool = True        # uint8 images, /255 on the device
    adaptive_question_len: bool = True    # ViT family only
    reduced_decode: int = 0               # 0 (off), 2 or 4
    dataset_type: str = "daquar"          # "daquar" or "okvqa"
    train_questions_json_fn: str = "OpenEnded_mscoco_train2014_questions.json"
    train_annotations_json_fn: str = "mscoco_train2014_annotations.json"
    test_questions_json_fn: str = "OpenEnded_mscoco_val2014_questions.json"
    test_annotations_json_fn: str = "mscoco_val2014_annotations.json"
    train_images_dir: str = "train2014"
    test_images_dir: str = "val2014"

    def validate(self) -> None:
        from . import constants
        if self.interpolation_strategy not in constants.INTERPOLATION_STRATEGIES:
            raise ValueError(
                f"interpolation_strategy={self.interpolation_strategy!r}"
            )
        if self.train_batch_size <= 0 or self.test_batch_size <= 0:
            raise ValueError("batch sizes must be positive")
        if self.dataset_type not in ("daquar", "okvqa"):
            raise ValueError(f"dataset_type={self.dataset_type!r} "
                             f"(expected 'daquar' or 'okvqa')")
        if self.reduced_decode not in (0, 2, 4):
            raise ValueError(f"reduced_decode={self.reduced_decode!r} "
                             f"(expected 0, 2 or 4)")


@dataclass
class TrainerConfig:
    """trainer_kwargs group."""
    epochs: int = 60
    monitor_train: bool = True
    monitor_val: bool = True
    monitor_test: bool = True
    device: str = "tpu"                  # the port: "cpu", else the card
    gradient_clipping: float = 1.0
    output_dir: str = "output"
    load_from_checkpoint: bool = False
    is_training: bool = True
    use_cache: bool = False
    first_val_epoch: int = 0
    metric_eval_mode: str = "strict"
    metric_average_mode: str = "macro"
    mxp_training: bool = False           # bfloat16 compute when True
    loss_combination_strategy: str = "dynamic_weighted"
    seed: int = 0
    log_every_fraction: float = 0.1      # step logs every 10% of an epoch
    trace_dir: str = ""                  # profiler trace directory
    steps_per_dispatch: int = 4          # optimizer steps per dispatch
    checkpoint_every_steps: int = 0      # 0: epoch-end checkpoints only
    checkpoint_snapshot_budget_mb: int = 0
    max_checkpoint_lag_epochs: int = 2
    compute_rouge: bool = False          # ROUGE over validation predictions
    use_wandb: bool = False
    wandb_project: str = "t5-resnet-vqa-tpu"
    fast_dropout_rng: bool = True        # the TPU's hardware RNG for dropout
    cache_frozen_features: bool = True   # frozen-tower feature cache

    def validate(self) -> None:
        if self.epochs <= 0:
            raise ValueError("epochs must be positive")
        if self.gradient_clipping is not None and self.gradient_clipping < 0:
            raise ValueError("gradient_clipping must be >= 0")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.checkpoint_every_steps < 0:
            raise ValueError("checkpoint_every_steps must be >= 0")
        if self.max_checkpoint_lag_epochs < -1:
            raise ValueError("max_checkpoint_lag_epochs must be >= -1")


@dataclass
class OptimizerConfig:
    """optimizer_kwargs group: per-module learning rates (vision_lr,
    lm_encoder_lr, fusion_lr for the projection, SGA and pooler,
    classifier_lr, default_lr for anything else)."""
    type: str = "AdamW"
    default_lr: float = 5e-5
    lm_encoder_lr: float = 5e-3
    lm_decoder_lr: float = 1e-4
    vision_lr: float = 8e-3
    classifier_lr: float = 1e-5
    fusion_lr: float = 5e-4
    kwargs: Dict[str, Any] = field(
        default_factory=lambda: {"weight_decay": 0.1, "amsgrad": True}
    )

    def validate(self) -> None:
        if self.type not in ("AdamW", "Adam", "SGD", "Lamb", "Adafactor"):
            raise ValueError(f"unsupported optimizer type {self.type!r}")


@dataclass
class LRSchedulerConfig:
    """lr_scheduler_kwargs group: linear warmup, then linear decay; warmup
    = min(num_warmup_steps, or total/10 when it is -1, max_warmup_steps)."""
    num_warmup_steps: int = -1
    num_training_steps: int = -1
    max_warmup_steps: int = 10000
    increase_batch_size_on_plateau: bool = False

    def resolve_warmup(self, total_steps: int) -> int:
        warmup = (
            self.num_warmup_steps
            if self.num_warmup_steps != -1
            else total_steps // 10
        )
        return min(warmup, self.max_warmup_steps)

    def validate(self) -> None:
        if self.max_warmup_steps < 0:
            raise ValueError("max_warmup_steps must be >= 0")


@dataclass
class CallbacksConfig:
    """callbacks_kwargs group (early stopping; patience is honoured)."""
    save_final_model: bool = False
    patience: int = 3
    mode: str = "max"
    threshold: float = 0.005

    def validate(self) -> None:
        if self.mode not in ("max", "min"):
            raise ValueError(f"mode must be max|min, got {self.mode!r}")
        if self.patience < 1:
            raise ValueError("patience must be >= 1")


@dataclass
class ParallelConfig:
    """parallel_kwargs group: the JAX package's (data, model) mesh sizes,
    kept for the file's round trip. As in the JAX package, nothing reads
    them: the entry points' ``--data-parallel`` / ``--model-parallel`` make
    the mesh (``parallel/``)."""
    data_axis_size: int = -1             # -1: all remaining devices
    model_axis_size: int = 1

    def validate(self) -> None:
        if self.model_axis_size < 1:
            raise ValueError("model_axis_size must be >= 1")


_GROUP_MAP = {
    "model_kwargs": ("model", ModelConfig),
    "dataset_kwargs": ("dataset", DatasetConfig),
    "trainer_kwargs": ("trainer", TrainerConfig),
    "optimizer_kwargs": ("optimizer", OptimizerConfig),
    "lr_scheduler_kwargs": ("lr_scheduler", LRSchedulerConfig),
    "callbacks_kwargs": ("callbacks", CallbacksConfig),
    "parallel_kwargs": ("parallel", ParallelConfig),
}


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    callbacks: CallbacksConfig = field(default_factory=CallbacksConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def validate(self) -> "Config":
        for f in dataclasses.fields(self):
            getattr(self, f.name).validate()
        return self

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        """Build from a reference-style dict of the kwarg groups; the
        reference nests the early-stopping args one level deeper
        (callbacks_kwargs.kwargs), and both layouts are accepted."""
        init: Dict[str, Any] = {}
        for group_key, (attr, group_cls) in _GROUP_MAP.items():
            group_raw = dict(raw.get(group_key, {}))
            if group_key == "callbacks_kwargs" and "kwargs" in group_raw:
                inner = group_raw.pop("kwargs")
                group_raw.update(inner)
            init[attr] = group_cls(**_filter_kwargs(group_cls, group_raw))
        return cls(**init).validate()

    @classmethod
    def from_json(cls, path: str, overrides: Optional[List[str]] = None) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        cfg = cls.from_dict(raw)
        for ov in overrides or []:
            cfg.apply_override(ov)
        return cfg.validate()

    def apply_override(self, assignment: str) -> None:
        """Apply ``group.key=value``; value parsed as JSON, else string.
        Takes both attribute names (``trainer.epochs``) and the reference's
        group names (``trainer_kwargs.epochs``)."""
        if "=" not in assignment:
            raise ValueError(f"override {assignment!r} must be key=value")
        path, value_str = assignment.split("=", 1)
        parts = path.strip().split(".")
        if len(parts) != 2:
            raise ValueError(f"override path {path!r} must be group.key")
        group_name, key = parts
        for gk, (attr, _) in _GROUP_MAP.items():
            if group_name in (gk, attr):
                group_name = attr
                break
        group = getattr(self, group_name, None)
        if group is None or not hasattr(group, key):
            raise ValueError(f"unknown config field {path!r}")
        try:
            value = json.loads(value_str)
        except json.JSONDecodeError:
            value = value_str
        setattr(group, key, value)

    def to_dict(self) -> Dict[str, Any]:
        """Dump back in the reference's group layout."""
        out = {}
        for group_key, (attr, _) in _GROUP_MAP.items():
            out[group_key] = dataclasses.asdict(getattr(self, attr))
        return out

    def param_table(self) -> List[Tuple[str, str]]:
        rows = []
        for group_key, (attr, _) in _GROUP_MAP.items():
            for k, v in dataclasses.asdict(getattr(self, attr)).items():
                rows.append((f"{group_key}.{k}", str(v)))
        return rows
