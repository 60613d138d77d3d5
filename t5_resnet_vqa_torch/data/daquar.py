"""DAQUAR sample records (the dataclasses of the JAX package's
``data/daquar.py``). Answers get space->underscore normalization."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Question:
    question_text: str
    question_id: str
    image_id: str

    def __str__(self) -> str:
        return (f"Id: {self.question_id}, Text: {self.question_text}, "
                f"Image_id: {self.image_id}")


@dataclasses.dataclass
class Annotation:
    question_id: str
    image_id: str
    answers: List[str]

    def __post_init__(self):
        self.answers = [a.replace(" ", "_") for a in self.answers]


@dataclasses.dataclass
class Sample:
    question: Question
    annotation: Annotation
    image_path: str
