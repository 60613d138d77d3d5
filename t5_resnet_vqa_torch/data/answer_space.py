"""Answer-space vocabulary construction (the JAX package's
``data/answer_space.py``).

Scans the train CSV's ``answers_list`` column, counts the answers after the
``Annotation`` normalization (space -> underscore), keeps those with at
least ``min_count`` occurrences, optionally drops multi-word answers
(those with a comma), always drops the 'O' class from the counted answers
and appends it last as the out-of-vocabulary bucket unless
``include_oov_class`` is off. The JAX package reads the file with pandas;
the port reads it with the ``csv`` module, as its ``DaquarDataset`` does
(the card's machine has no pandas), and gives the same list.
"""

from __future__ import annotations

import ast
import csv
from collections import Counter
from typing import List


def build_answer_space(
    train_csv_path: str,
    min_count: int = 5,
    single_word_only: bool = True,
    include_oov_class: bool = True,
) -> List[str]:
    with open(train_csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    counts: Counter = Counter()
    for row in rows:
        for ans in ast.literal_eval(row["answers_list"]):
            counts[str(ans).replace(" ", "_")] += 1

    kept = sorted(ans for ans, n in counts.items()
                  if n >= min_count and ans != "O"
                  and not (single_word_only and "," in ans))
    if include_oov_class:
        kept.append("O")
    return kept


def write_answer_space(answers: List[str], path: str) -> None:
    with open(path, "w") as f:
        f.write("\n".join(answers) + "\n")
