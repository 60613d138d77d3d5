"""Models: ResNet backbone, ViT tower, T5 encoder and decoder, the CNN- and
ViT-family VQA models, and answer generation."""

from .generation import beam_generate, greedy_generate
from .image_input import finalize_image_input
from .resnet import (
    BasicBlock,
    Bottleneck,
    FrozenBatchNorm,
    ResNetBackbone,
    resnet_out_channels,
)
from .resnet_vqa import ResnetVQAModel, init_weights
from .t5 import T5Config, T5Decoder, T5Encoder, T5ForConditionalGeneration
from .vit import ViTConfig, ViTModel
from .vit_vqa import VitVQAModel

__all__ = [
    "BasicBlock", "Bottleneck", "FrozenBatchNorm", "ResNetBackbone",
    "ResnetVQAModel", "T5Config", "T5Decoder", "T5Encoder",
    "T5ForConditionalGeneration", "ViTConfig", "ViTModel", "VitVQAModel",
    "beam_generate", "finalize_image_input", "greedy_generate",
    "init_weights", "resnet_out_channels",
]
