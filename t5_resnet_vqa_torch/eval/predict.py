"""Prediction decoding helpers: argmax and top-k over [B, A] log-probs."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def convert_logits_to_predictions(log_probs) -> np.ndarray:
    """[B, A] log-probs -> [B] predicted class indices."""
    return np.argmax(np.asarray(log_probs), axis=-1)


def convert_logits_to_predictions_topk(log_probs, k: int) -> np.ndarray:
    """[B, A] log-probs -> [B, k] top-k class indices (best first)."""
    lp = np.asarray(log_probs)
    return np.argsort(-lp, axis=-1)[:, :k]


def predictions_to_answers(indices: Sequence[int],
                           answer_spaces: List[str]) -> List[str]:
    return [answer_spaces[int(i)] for i in indices]
