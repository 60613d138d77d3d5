"""DAQUAR records and dataset (the JAX package's ``data/daquar.py``):
Question/Annotation/Sample, the csv-backed ``DaquarDataset`` and
``load_answer_spaces``. Answers get space->underscore normalization."""

from __future__ import annotations

import ast
import csv
import dataclasses
import os
from typing import Dict, List


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


class DaquarDataset:
    """Map-style dataset over the DAQUAR csv (columns ``image_id``,
    ``question``, ``answers_list``; the last a python-literal list), with an
    image_id -> filename map from the images directory.

    The JAX package reads the file with pandas; the port reads it with the
    ``csv`` module (the card's machine has no pandas) and gives the same
    rows: the same Question/Annotation ids and texts, and the same answers.
    """

    def __init__(self, root_dir: str, csv_file_path: str, images_dir: str,
                 type: str = "train"):
        with open(os.path.join(root_dir, csv_file_path), newline="") as f:
            self.data = list(csv.DictReader(f))
        self.images_dir = os.path.join(root_dir, images_dir)
        self.type = type

        self.image_ids_to_fn: Dict[str, str] = {}
        for image_fn in os.listdir(self.images_dir):
            self.image_ids_to_fn[image_fn.split(".")[0]] = image_fn

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Sample:
        row = self.data[idx]
        image_id = row["image_id"]
        question = Question(
            question_text=row["question"],
            question_id=f"{image_id}_{idx}_Question",
            image_id=image_id,
        )
        annotation = Annotation(
            question_id=f"{image_id}__{idx}_Question",
            image_id=image_id,
            answers=list(ast.literal_eval(row["answers_list"])),
        )
        image_fn = self.image_ids_to_fn[image_id]
        return Sample(question, annotation,
                      os.path.join(self.images_dir, image_fn))


def load_answer_spaces(path: str) -> List[str]:
    """Answer-space file, one answer per line."""
    with open(path) as f:
        return [line.strip("\n") for line in f.readlines()]
