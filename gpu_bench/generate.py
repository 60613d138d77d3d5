"""The one generator of traffic: everything a mix's parameters and a seed
make. The same seed gives the same images, questions, calls and samples.

* ``QuestionBank``: DAQUAR-style questions from the mix's template grammar
  (``questions.templates`` with ``{slot}`` words from
  ``questions.words``), a bank drawn once per run from the seed.
* ``image_pool``: seeded uint8 RGB images made on the device in one call
  and held on the host; requests and samples name them by index.
* ``serve_call``: call j of a closed-loop client: ``requests_per_call``
  (image, question) pairs, each image and question drawn from the seed
  and j.
* ``train_samples``: the training set: a question, an image and one or
  more answers per sample.
"""

from __future__ import annotations

import re
from typing import List, Mapping, Sequence, Tuple

import numpy as np

from . import harness

BANK_SIZE = 8192
_SLOT = re.compile(r"\{(\w+)\}")


class QuestionBank:
    def __init__(self, grammar: Mapping, seed: int, size: int = BANK_SIZE):
        r = harness.rng(seed, harness.QUESTIONS)
        templates, words = grammar["templates"], grammar["words"]
        self.texts: List[str] = []
        for _ in range(size):
            t = templates[int(r.integers(len(templates)))]
            self.texts.append(_SLOT.sub(
                lambda m: words[m.group(1)][int(r.integers(
                    len(words[m.group(1)])))], t))

    def __len__(self) -> int:
        return len(self.texts)


def image_pool(n: int, size: int, seed: int, device) -> np.ndarray:
    """[n, size, size, 3] uint8, drawn on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, harness.IMAGES))
    images = torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                           generator=gen, device=device)
    return images.cpu().numpy()


def serve_call(mix: Mapping, seed: int, j: int, n_images: int,
               bank: QuestionBank) -> Tuple[np.ndarray, np.ndarray]:
    """(image indices, question indices) of call ``j``; warm-up calls take
    negative ``j``."""
    r = harness.rng(seed, harness.CALLS, j + 2 ** 20)
    n = mix["requests_per_call"]
    return r.integers(n_images, size=n), r.integers(len(bank), size=n)


def train_samples(mix: Mapping, seed: int, answers: Sequence[str],
                  bank: QuestionBank
                  ) -> Tuple[List[str], np.ndarray, List[List[str]]]:
    """(question texts, image indices, answer lists) of the training set."""
    r = harness.rng(seed, harness.SAMPLES)
    n = mix["samples"]
    lo, hi = mix["answers_per_question"]
    questions = [bank.texts[int(i)] for i in r.integers(len(bank), size=n)]
    images = r.integers(mix["distinct_images"], size=n)
    counts = r.integers(lo, hi + 1, size=n)
    picks = r.integers(len(answers), size=(n, hi))
    answer_lists = [[answers[int(a)] for a in picks[i, :counts[i]]]
                    for i in range(n)]
    return questions, images, answer_lists
