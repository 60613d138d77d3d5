"""Utilities: the weight bridge from JAX param trees, time formatting."""

from .time_utils import convert_time_to_readable_format
from .weights import (
    cross_attention_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
    state_dict_from_jax,
    vit_state_dict_from_jax,
)

__all__ = ["convert_time_to_readable_format",
           "cross_attention_state_dict_from_jax",
           "faster_rcnn_state_dict_from_jax", "state_dict_from_jax",
           "vit_state_dict_from_jax"]
