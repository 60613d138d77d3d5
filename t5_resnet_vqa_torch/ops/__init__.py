"""Fusion ops and the hand-written CUDA kernels with their plain versions;
Kimi-VL's sparse experts (``moe``) and latent attention (``mla``), on
library calls."""

from .attention import attention_reference, fused_attention
from .bottleneck import bottleneck_reference, fold_conv_bn, fused_bottleneck
from .layers import (
    FFN,
    MLP,
    SGA,
    AttentionConfig,
    AttentionPooler,
    ChannelProjection,
    LayerNorm,
    MultiHeadAttention,
    SGAStack,
    dot_product_attention,
    log_softmax_nll,
)

__all__ = [
    "FFN", "MLP", "SGA", "AttentionConfig", "AttentionPooler",
    "ChannelProjection", "LayerNorm", "MultiHeadAttention", "SGAStack",
    "attention_reference", "bottleneck_reference", "dot_product_attention",
    "fold_conv_bn", "fused_attention", "fused_bottleneck", "log_softmax_nll",
]
