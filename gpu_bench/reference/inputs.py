"""The reference's own derivation of the model inputs from what the
benchmark makes (question texts, image indices, answer lists).

The program derives token ids, labels and the batch order with its own
collate, tokenizer and loader; the reference works them out again here, so
that nothing the program made reaches it:

* ``hash_tokenize``: the offline hash tokenizer that the configurations
  assume (``assumed`` in each config file): ``[Question] {text}``, words
  hashed with MD5 into [1000, 32000), answer-space words pinned at
  [100, 1000) in sorted order, special tokens at 32100 + their index, EOS
  (1) closing the sequence, 0 padding it to its length.
* ``shuffled_order`` and ``drawn_labels``: the loader's shuffle (a NumPy
  ``default_rng(seed)`` permutation per epoch) and the collate's choice of
  one answer per question (``rng.integers(len(answers))`` per sample, in
  batch order).
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

QUESTION_TOKEN = "[Question]"
ANSWER_TOKEN = "[Answer]"
QUESTION_TYPE_TOKEN = "[QUESTION_TYPE]"
QUESTION_TYPE_WORDS = (
    "Plants_and_Animals", "Science_and_Technology", "Sports_and_Recreation",
    "Geography,_History,_Language_and_Culture",
    "Brands,_Companies_and_Products", "Other",
    "Vehicles_and_Transportation", "Cooking_and_Food",
    "Weather_and_Climate", "People_and_Everyday_life",
    "Objects,_Material_and_Clothing")
SPECIALS = (QUESTION_TOKEN, ANSWER_TOKEN, QUESTION_TYPE_TOKEN) \
    + QUESTION_TYPE_WORDS
FIRST_EXTRA_ID = 32100
PAD, EOS = 0, 1
_WORD = re.compile(r"[a-zA-Z0-9']+|[^\sa-zA-Z0-9]")
_SPECIAL = re.compile("(" + "|".join(re.escape(t) for t in SPECIALS) + ")")


def pinned_ids(answers: Sequence[str]) -> Dict[str, int]:
    words = sorted({w.lower() for a in answers for w in _WORD.findall(a)})
    return {w: 100 + i for i, w in enumerate(words)}


def _word_id(word: str, pinned: Dict[str, int]) -> int:
    word = word.lower()
    if word in pinned:
        return pinned[word]
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
    return 1000 + h % 31000


def hash_tokenize(texts: Sequence[str], max_length: int,
                  pinned: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask), int64 [B, max_length]."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        toks: List[int] = []
        for chunk in _SPECIAL.split(text):
            if not chunk:
                continue
            if chunk in SPECIALS:
                toks.append(FIRST_EXTRA_ID + SPECIALS.index(chunk))
            else:
                toks.extend(_word_id(w, pinned) for w in _WORD.findall(chunk))
        toks = toks[:max_length - 1] + [EOS]
        ids[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return ids, mask


def question_ids(questions: Sequence[str], max_length: int,
                 answers: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    return hash_tokenize([f"{QUESTION_TOKEN} {q}" for q in questions],
                         max_length, pinned_ids(answers))


def shuffled_order(n: int, seed: int, epochs: int = 1) -> np.ndarray:
    """The loader's sample order over ``epochs`` epochs."""
    rng = np.random.default_rng(seed)
    orders = []
    for _ in range(epochs):
        order = np.arange(n)
        rng.shuffle(order)
        orders.append(order)
    return np.concatenate(orders)


def drawn_labels(answer_lists: Sequence[Sequence[str]], seed: int,
                 answers: Sequence[str]) -> np.ndarray:
    """The label of each sample, in the order the collate saw them."""
    rng = np.random.default_rng(seed)
    index = {a: i for i, a in enumerate(answers)}
    out = np.empty(len(answer_lists), np.int64)
    for i, choices in enumerate(answer_lists):
        out[i] = index[choices[int(rng.integers(len(choices)))]]
    return out
