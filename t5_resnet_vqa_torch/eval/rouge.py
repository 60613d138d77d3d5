"""ROUGE-1/2/L metric helper (a copy of the JAX package's ``eval/rouge.py``).

Parity with the reference's ``compute_rouge_metric``
(faster_rcnn_vqa_trainer.py:489-513), which wraps the ``rouge_score`` pip
package. The scorer is implemented here directly: token-level
unigram/bigram overlap (rouge1/rouge2) and LCS (rougeL), each as
precision/recall/fmeasure, with Porter stemming (the reference passes
use_stemmer=True) when ``nltk`` imports; without it tokens are not stemmed
(``stemming_active`` says which), exactly as in the JAX package.
"""

from __future__ import annotations

import functools
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


@functools.lru_cache(maxsize=None)
def _stemmer():
    """nltk's ``PorterStemmer``, or None where nltk does not import."""
    try:
        from nltk.stem.porter import PorterStemmer
    except ImportError:
        return None
    return PorterStemmer()


def stemming_active() -> bool:
    """Whether ``score`` stems its tokens (nltk imports)."""
    return _stemmer() is not None


def _tokenize(text: str, use_stemmer: bool) -> List[str]:
    toks = [t for t in "".join(
        c.lower() if c.isalnum() else " " for c in text).split() if t]
    stemmer = _stemmer() if use_stemmer else None
    if stemmer is not None:
        toks = [stemmer.stem(t) for t in toks]
    return toks


def _prf(overlap: int, pred_n: int, target_n: int) -> Dict[str, float]:
    precision = overlap / pred_n if pred_n else 0.0
    recall = overlap / target_n if target_n else 0.0
    f = (2 * precision * recall / (precision + recall)
         if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "fmeasure": f}


def _ngram_score(pred: List[str], target: List[str], n: int) -> Dict[str, float]:
    def ngrams(toks):
        return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))
    p, t = ngrams(pred), ngrams(target)
    overlap = sum((p & t).values())
    return _prf(overlap, sum(p.values()), sum(t.values()))


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, start=1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def score(target: str, prediction: str,
          use_stemmer: bool = True) -> Dict[str, Dict[str, float]]:
    """rouge_score.RougeScorer(['rouge1','rouge2','rougeL']).score parity."""
    p = _tokenize(prediction, use_stemmer)
    t = _tokenize(target, use_stemmer)
    return {
        "rouge1": _ngram_score(p, t, 1),
        "rouge2": _ngram_score(p, t, 2),
        "rougeL": _prf(_lcs_len(p, t), len(p), len(t)),
    }


def compute_rouge_metric(predictions: Sequence[int], targets: Sequence[int],
                         answer_spaces: List[str]) -> Tuple[dict, dict]:
    """Reference signature (trainer :489-513): class-index lists -> averaged
    {rouge1/2/L: {precision, recall, fmeasure}}."""
    pred_texts = [answer_spaces[i] for i in predictions]
    target_texts = [answer_spaces[i] for i in targets]

    output_dict: dict = defaultdict(dict)
    overall: dict = defaultdict(lambda: defaultdict(float))
    for pred, target in zip(pred_texts, target_texts):
        for score_type, metrics in score(target, pred).items():
            for k, v in metrics.items():
                overall[score_type][k] += v
    n = max(1, len(pred_texts))
    for score_type in overall:
        for k in overall[score_type]:
            overall[score_type][k] /= n
    return output_dict, overall
