"""The OK-VQA data path: COCO-style question and annotation JSONs (the JAX
package's ``data/okvqa.py``).

* ``OKVQADataset`` reads ``{"questions": [...]}`` and ``{"annotations":
  [...]}`` and maps each ``image_id`` to its file through the COCO names
  ``COCO_{train,val}2014_<12-digit id>.<ext>`` of the images directory.
* ``OkVqaTrainableDataset`` gives the same rows through the DAQUAR
  ``Sample`` contract, with all 10 annotator answers in the ``Annotation``
  (space -> underscore), so the DAQUAR collates, the trainer of every
  family, the feature cache and the session take it unchanged: the
  collate's seeded answer choice draws one annotator answer per epoch, and
  answers outside the answer space go to its 'O' class. The trainer picks
  it with ``dataset_kwargs.dataset_type="okvqa"``.
* ``OkVqaCollate`` is the legacy batch of the 10-answer token grid
  [B, 10, MAX_LEN], unnormalized NHWC images and the question-type ids
  (``core/constants.QUESTION_TYPES``); questions pad to MAX_LEN.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..core import constants
from .daquar import Annotation, Question, Sample
from .preprocessing import load_image_batch
from .tokenizer import get_tokenizer


@dataclasses.dataclass
class OkVqaAnnotation:
    question_id: int
    image_id: int
    question_type: str
    answers: List[dict]          # [{"answer": str, ...} x 10]
    answer_type: str


@dataclasses.dataclass
class OkVqaSample:
    question: Question
    annotation: OkVqaAnnotation
    image_path: str


class OKVQADataset:
    """COCO-style OK-VQA dataset: row ``idx`` pairs question ``idx`` with
    annotation ``idx``."""

    def __init__(self, annotations_json: dict, questions_json: dict,
                 images_dir: str, type: str = "train"):
        self.images_dir = images_dir
        self.type = type
        self.questions = questions_json["questions"]
        self.annotations = annotations_json["annotations"]

        prefix = f"COCO_{'train' if type == 'train' else 'val'}2014_"
        self.image_ids_to_fn: Dict[int, str] = {}
        for image_fn in os.listdir(images_dir):
            if prefix not in image_fn:
                continue
            image_id = image_fn.split(prefix)[1].lstrip("0").split(".")[0]
            self.image_ids_to_fn[int(image_id)] = image_fn

    def __len__(self) -> int:
        return len(self.questions)

    def __getitem__(self, idx: int) -> OkVqaSample:
        q = self.questions[idx]
        a = self.annotations[idx]
        question = Question(q["question"], q["question_id"], q["image_id"])
        annotation = OkVqaAnnotation(
            a["question_id"], a["image_id"], a["question_type"],
            a["answers"], a.get("answer_type", ""))
        image_fn = self.image_ids_to_fn[int(question.image_id)]
        return OkVqaSample(question, annotation,
                           os.path.join(self.images_dir, image_fn))


class OkVqaTrainableDataset:
    """OK-VQA rows as DAQUAR ``Sample`` records (see the module
    docstring)."""

    def __init__(self, annotations_json: dict, questions_json: dict,
                 images_dir: str, type: str = "train"):
        self._ds = OKVQADataset(annotations_json, questions_json, images_dir,
                                type)

    @staticmethod
    def from_files(root_dir: str, annotations_fn: str, questions_fn: str,
                   images_dir: str, type: str = "train"
                   ) -> "OkVqaTrainableDataset":
        with open(os.path.join(root_dir, annotations_fn)) as f:
            ann = json.load(f)
        with open(os.path.join(root_dir, questions_fn)) as f:
            qs = json.load(f)
        return OkVqaTrainableDataset(ann, qs,
                                     os.path.join(root_dir, images_dir), type)

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, idx: int) -> Sample:
        s = self._ds[idx]
        annotation = Annotation(
            question_id=str(s.annotation.question_id),
            image_id=str(s.annotation.image_id),
            answers=[a["answer"] for a in s.annotation.answers],
        )
        return Sample(s.question, annotation, s.image_path)


class OkVqaCollate:
    """The legacy OK-VQA batch: question "[Question] {q} [QUESTION_TYPE]
    {type}" and the annotators' answers as a [B, 10, MAX_LEN] token grid,
    images resized and scaled to [0, 1] (unnormalized), question-type ids;
    with ``eval_mode`` also the answer and question records."""

    def __init__(self, resizing_dimensions=(256, 256),
                 interpolation_strategy: str = "bilinear_interpolation",
                 lang_model: str = "t5-base", eval_mode: bool = False,
                 tokenizer=None, use_native: bool = True):
        self.resizing_dimensions = tuple(resizing_dimensions)
        self.interpolation_strategy = interpolation_strategy
        self.eval_mode = eval_mode
        self.tokenizer = tokenizer or get_tokenizer(lang_model)
        self.use_native = use_native

    def __call__(self, samples: Sequence[OkVqaSample]) -> Dict[str, np.ndarray]:
        images = load_image_batch(
            [s.image_path for s in samples], self.resizing_dimensions,
            self.interpolation_strategy, normalize=None,
            use_native=self.use_native)

        B = len(samples)
        n_ans = constants.ANSWERS_PER_QUESTION
        annotations_ids = np.zeros((B, n_ans, constants.MAX_LEN), np.int32)
        question_type_ids = np.zeros((B,), np.int32)
        question_types: List[str] = []
        for i, s in enumerate(samples):
            answers = [a["answer"] for a in s.annotation.answers][:n_ans]
            ids, _ = self.tokenizer(answers, constants.MAX_LEN)
            annotations_ids[i, :len(answers)] = ids
            question_types.append(s.annotation.question_type)
            question_type_ids[i] = constants.QUESTION_TYPE_TO_IDS[
                s.annotation.question_type]

        question_texts = [
            f"{constants.QUESTION_SPECIAL_TOKEN} {s.question.question_text} "
            f"{constants.QUESTION_TYPE_SPECIAL_TOKEN} {question_types[i]}"
            for i, s in enumerate(samples)
        ]
        q_ids, q_mask = self.tokenizer(question_texts, constants.MAX_LEN)

        batch = {
            "question_input_ids": q_ids,
            "question_attention_masks": q_mask,
            "annotation_ids": annotations_ids,
            "image_tensors": images,
            "question_type_ids": question_type_ids,
        }
        if self.eval_mode:
            batch["answers"] = [s.annotation.answers for s in samples]
            batch["questions"] = [s.question for s in samples]
        return batch
