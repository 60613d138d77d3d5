"""Models: ResNet backbone, FPN, ViT tower, T5 encoder and decoder, RoBERTa
pieces, the VQA models of the four families (ResNet, Faster-RCNN, ViT + T5
encoder-decoder, ViT x RoBERTa cross-attention), Kimi-VL (MoonViT and a
DeepSeek-V3 decoder), and answer generation."""

from .cross_attention_vqa import CrossAttentionVitVQAModel
from .faster_rcnn_vqa import FasterRcnnVQAModel
from .fpn import FPN
from .generation import (
    beam_generate,
    cached_greedy_generate,
    greedy_generate,
)
from .image_input import finalize_image_input
from .kimi_vl import (
    KimiTextConfig,
    KimiVLConfig,
    KimiVLModel,
    MoonViTConfig,
    build_kimi_vl,
)
from .resnet import (
    BasicBlock,
    Bottleneck,
    FrozenBatchNorm,
    ResNetBackbone,
    resnet_out_channels,
)
from .resnet_vqa import ResnetVQAModel, init_weights
from .roberta import RobertaConfig, RobertaEmbeddings, RobertaLayer
from .t5 import T5Config, T5Decoder, T5Encoder, T5ForConditionalGeneration
from .vit import ViTConfig, ViTModel
from .vit_vqa import VitVQAModel

__all__ = [
    "BasicBlock", "Bottleneck", "CrossAttentionVitVQAModel", "FPN",
    "FasterRcnnVQAModel", "FrozenBatchNorm", "KimiTextConfig",
    "KimiVLConfig", "KimiVLModel", "MoonViTConfig", "ResNetBackbone",
    "ResnetVQAModel", "RobertaConfig", "RobertaEmbeddings", "RobertaLayer",
    "T5Config", "T5Decoder", "T5Encoder",
    "T5ForConditionalGeneration", "ViTConfig", "ViTModel", "VitVQAModel",
    "beam_generate", "build_kimi_vl", "cached_greedy_generate",
    "finalize_image_input", "greedy_generate",
    "init_weights", "resnet_out_channels",
]
