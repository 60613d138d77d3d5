"""Constants, config, logging and device selection."""

from . import constants
from .config import (
    CallbacksConfig,
    Config,
    DatasetConfig,
    LRSchedulerConfig,
    ModelConfig,
    OptimizerConfig,
    ParallelConfig,
    TrainerConfig,
)
from .device import resolve_device
from .logging import ExperimentTracker, Logger

__all__ = [
    "CallbacksConfig", "Config", "DatasetConfig", "ExperimentTracker",
    "LRSchedulerConfig", "Logger", "ModelConfig", "OptimizerConfig",
    "ParallelConfig", "TrainerConfig", "constants", "resolve_device",
]
