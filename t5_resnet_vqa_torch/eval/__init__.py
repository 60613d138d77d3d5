"""Serving and prediction decoding."""

from .predict import (
    convert_logits_to_predictions,
    convert_logits_to_predictions_topk,
    predictions_to_answers,
)
from .session import CNN_FAMILY, VIT_FAMILY, VQAInferenceSession

__all__ = [
    "CNN_FAMILY", "VIT_FAMILY", "VQAInferenceSession", "convert_logits_to_predictions",
    "convert_logits_to_predictions_topk", "predictions_to_answers",
]
