"""WUPS (Wu-Palmer similarity) answer metric.

Parity with the reference's dataset_utils/wup_measure.py:3-61:
  * exact string match -> 1.0 (ref :31-33)
  * otherwise the most optimistic pairwise ``wup_similarity`` over the two
    answers' WordNet noun synsets (ref :46-51)
  * scores below the 0.925 threshold are downweighted x0.1 (ref :55-58)
  * empty synsets -> 0 (ref :42-43)

This is host-side string work and stays off-device (SURVEY §7 hard-part 6).
Three tiers, best available wins (``wups_mode()`` reports which is active):

  1. ``wordnet``      — NLTK with its corpus installed: reference-exact.
  2. ``mini-wordnet`` — vendored DAQUAR-vocabulary noun taxonomy
                        (eval/mini_wordnet.py) running the SAME Wu-Palmer
                        depth math and 0.925/x0.1 thresholding; scores are
                        WordNet-like but only reference-exact where the
                        vendored chains match WordNet 3.0.
  3. ``exact-match-fallback`` — unreachable unless the vendored data is
                        removed; kept as the documented degraded mode.

Pair-level results are memoized (12.5k pairs/epoch hit a few hundred unique
answer pairs), so the O(synset^2) search runs once per pair per process.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

_wordnet = None
_checked = False


def _get_wordnet():
    global _wordnet, _checked
    if _checked:
        return _wordnet
    _checked = True
    try:
        from nltk.corpus import wordnet
        wordnet.synsets("dog")  # force-load; raises if corpus missing
        _wordnet = wordnet
    except Exception:
        _wordnet = None
    return _wordnet


def _get_mini():
    try:
        from . import mini_wordnet
        return mini_wordnet
    except Exception:
        return None


def wups_mode() -> str:
    if _get_wordnet() is not None:
        return "wordnet"
    if _get_mini() is not None:
        return "mini-wordnet"
    return "exact-match-fallback"


@lru_cache(maxsize=65536)
def _noun_synsets(word: str):
    wn = _get_wordnet()
    return tuple(wn.synsets(word, pos=wn.NOUN)) if wn is not None else ()


@lru_cache(maxsize=262144)
def wup_measure(a: str, b: str, similarity_threshold: float = 0.925) -> float:
    """Reference-exact scoring; see module docstring."""
    # get_stem_word is an identity with weight 1.0 in the reference (:16-29)
    global_weight = 1.0

    if a == b:
        return 1.0 * global_weight
    if a == [] or b == []:
        return 0.0

    wn = _get_wordnet()
    if wn is not None:
        interp_a = _noun_synsets(a)
        interp_b = _noun_synsets(b)
        if not interp_a or not interp_b:
            return 0.0
        global_max = 0.0
        for x in interp_a:
            for y in interp_b:
                score = x.wup_similarity(y)
                if score is not None and score > global_max:
                    global_max = score
    else:
        mini = _get_mini()
        if mini is None:
            return 0.0  # degraded mode: non-exact answers score 0
        global_max = mini.max_wup(a, b)
        if global_max < 0.0:  # OOV == empty synsets (ref :42-43)
            return 0.0

    interp_weight = 1.0 if global_max >= similarity_threshold else 0.1
    return global_max * interp_weight * global_weight


def batch_wups(predictions: Sequence[str], targets: Sequence[str]) -> List[float]:
    return [wup_measure(p, t) for p, t in zip(predictions, targets)]


def average_wups(predictions: Sequence[str], targets: Sequence[str]) -> float:
    scores = batch_wups(predictions, targets)
    return sum(scores) / len(scores) if scores else 0.0
