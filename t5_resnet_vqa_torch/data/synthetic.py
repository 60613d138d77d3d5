"""Synthetic DAQUAR and OK-VQA generators for tests and trial runs.

Copies of ``make_synthetic_daquar`` and ``make_synthetic_okvqa`` of the
JAX package's ``data/synthetic.py``: the same files for the same seed, in
the on-disk layouts the datasets read (DAQUAR: root/{train.csv,test.csv,
answer_spaces.txt,images/*.png}, CSV columns image_id,question,
answers_list; OK-VQA: the COCO question and annotation JSONs of each split
beside {train,val}2014/COCO_<split>2014_<12-digit id>.png). cv2 (or PIL)
is imported only to write the images.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

_OBJECTS = ["table", "chair", "lamp", "sofa", "television", "bottle",
            "book", "cup", "door", "window", "photo", "bed"]
_COLORS = ["red", "blue", "green", "white", "black", "brown"]


def make_synthetic_daquar(
    root: str,
    num_train: int = 16,
    num_test: int = 8,
    num_images: int = 6,
    image_size: int = 64,
    source_hw: Optional[Tuple[int, int]] = None,
    seed: int = 0,
) -> Tuple[str, dict]:
    """Writes the dataset under ``root``; returns (root, dataset_kwargs).

    ``source_hw`` sets the on-disk image geometry apart from the model's
    ``image_size`` (real DAQUAR frames are 640x480), so that the resize
    does real work.
    """
    rng = np.random.default_rng(seed)
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir, exist_ok=True)

    sh, sw = source_hw if source_hw is not None else (image_size, image_size)
    image_ids: List[str] = []
    for i in range(num_images):
        image_id = f"image{i}"
        arr = rng.integers(0, 256, size=(sh, sw, 3),
                           dtype=np.uint8)
        _write_png(os.path.join(images_dir, f"{image_id}.png"), arr)
        image_ids.append(image_id)

    answer_spaces = sorted(set(_OBJECTS + _COLORS + ["O"]))
    with open(os.path.join(root, "answer_spaces.txt"), "w") as f:
        f.write("\n".join(answer_spaces) + "\n")

    def write_csv(name: str, n: int):
        rows = ["image_id,question,answers_list"]
        for i in range(n):
            image_id = image_ids[int(rng.integers(len(image_ids)))]
            if rng.random() < 0.5:
                obj = _OBJECTS[int(rng.integers(len(_OBJECTS)))]
                q = f"what is on the {obj}"
                answers = [_OBJECTS[int(rng.integers(len(_OBJECTS)))]]
            else:
                q = "what colour is the object in the corner"
                answers = [_COLORS[int(rng.integers(len(_COLORS)))]]
            if rng.random() < 0.3:
                answers.append(answers[0])  # duplicate answers happen in DAQUAR
            rows.append(f'{image_id},{q},"{answers!r}"')
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")

    write_csv("train.csv", num_train)
    write_csv("test.csv", num_test)

    dataset_kwargs = {
        "root_data_dir": root,
        "train_csv_file": "train.csv",
        "test_csv_file": "test.csv",
        "answer_spaces_file": "answer_spaces.txt",
        "images_dir": "images",
        "image_preprocessor_model": "google/vit-base-patch16-224-in21k",
        "language_model_tokenizer": "t5-base",
        "train_batch_size": 4,
        "test_batch_size": 4,
    }
    return root, dataset_kwargs


def make_synthetic_okvqa(
    root: str,
    num_train: int = 16,
    num_test: int = 8,
    num_images: int = 6,
    image_size: int = 64,
    seed: int = 0,
) -> Tuple[str, dict]:
    """Writes the COCO-style corpus under ``root``; returns (root,
    dataset_kwargs with ``dataset_type="okvqa"``). Each annotation carries
    a 10-answer annotator grid: 7 votes for one colour and 3 random ones."""
    import json

    from ..core import constants

    rng = np.random.default_rng(seed)
    qtypes = list(constants.QUESTION_TYPES)

    def write_split(split: str, n: int, id_base: int):
        images_dir = os.path.join(root, f"{split}2014")
        os.makedirs(images_dir, exist_ok=True)
        image_ids = []
        for i in range(num_images):
            image_id = id_base + i
            arr = rng.integers(0, 256, size=(image_size, image_size, 3),
                               dtype=np.uint8)
            _write_png(os.path.join(
                images_dir, f"COCO_{split}2014_{image_id:012d}.png"), arr)
            image_ids.append(image_id)

        questions, annotations = [], []
        for i in range(n):
            qid = id_base * 10 + i
            image_id = image_ids[int(rng.integers(len(image_ids)))]
            obj = _OBJECTS[int(rng.integers(len(_OBJECTS)))]
            majority = _COLORS[int(rng.integers(len(_COLORS)))]
            votes = [majority] * 7 + [
                _COLORS[int(rng.integers(len(_COLORS)))] for _ in range(3)]
            questions.append({"question": f"what color is the {obj}",
                              "question_id": qid, "image_id": image_id})
            annotations.append({
                "question_id": qid, "image_id": image_id,
                "question_type": qtypes[int(rng.integers(len(qtypes)))],
                "answer_type": "other",
                "answers": [{"answer": v, "answer_confidence": "yes",
                             "answer_id": k + 1}
                            for k, v in enumerate(votes)],
            })
        with open(os.path.join(
                root, f"OpenEnded_mscoco_{split}2014_questions.json"),
                "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(
                root, f"mscoco_{split}2014_annotations.json"), "w") as f:
            json.dump({"annotations": annotations}, f)

    os.makedirs(root, exist_ok=True)
    write_split("train", num_train, 100)
    write_split("val", num_test, 200)
    answer_spaces = sorted(set(_COLORS + ["O"]))
    with open(os.path.join(root, "answer_spaces.txt"), "w") as f:
        f.write("\n".join(answer_spaces) + "\n")

    dataset_kwargs = {
        "root_data_dir": root,
        "dataset_type": "okvqa",
        "answer_spaces_file": "answer_spaces.txt",
        "train_questions_json_fn": "OpenEnded_mscoco_train2014_questions.json",
        "train_annotations_json_fn": "mscoco_train2014_annotations.json",
        "test_questions_json_fn": "OpenEnded_mscoco_val2014_questions.json",
        "test_annotations_json_fn": "mscoco_val2014_annotations.json",
        "train_images_dir": "train2014",
        "test_images_dir": "val2014",
        "language_model_tokenizer": "t5-base",
        "train_batch_size": 4,
        "test_batch_size": 4,
    }
    return root, dataset_kwargs


def _write_png(path: str, arr: np.ndarray) -> None:
    try:
        import cv2
    except ImportError:
        from PIL import Image
        Image.fromarray(arr).save(path)
        return
    cv2.imwrite(path, arr[:, :, ::-1])  # RGB -> BGR for cv2
