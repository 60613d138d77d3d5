"""Models: ResNet backbone, T5 encoder and the CNN-family VQA model."""

from .image_input import finalize_image_input
from .resnet import (
    BasicBlock,
    Bottleneck,
    FrozenBatchNorm,
    ResNetBackbone,
    resnet_out_channels,
)
from .resnet_vqa import ResnetVQAModel, init_weights
from .t5 import T5Config, T5Encoder

__all__ = [
    "BasicBlock", "Bottleneck", "FrozenBatchNorm", "ResNetBackbone",
    "ResnetVQAModel", "T5Config", "T5Encoder", "finalize_image_input",
    "init_weights", "resnet_out_channels",
]
