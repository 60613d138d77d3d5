"""The OK-VQA data path of the port against the JAX package's.

* ``make_synthetic_okvqa`` writes the JAX generator's files, byte for byte.
* ``OKVQADataset`` rows (COCO file names), ``OkVqaTrainableDataset``
  samples (the 10 annotator answers behind the DAQUAR ``Annotation``) and
  ``OkVqaCollate`` batches (the [B, 10, MAX_LEN] answer grid, question-type
  ids, images on the cv2 and the native path) equal JAX's.
* ``VQATrainer`` with ``dataset_type="okvqa"``: one epoch of 2 train steps
  (8 questions, batch 4) and a validation pass on 6 questions (the last
  batch padded), dropout 0, from the same params as JAX's ``VQATrainer``
  (the tiny CNN model of ``test_torch_trainer.py``, with the cache on, the
  config's default): the train and validation losses within 1e-5
  relative, the same validation predictions, JAX's dataset log line, and
  every label drawn from its question's annotator grid.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data.okvqa import OKVQADataset as JaxOkvqaDataset
from t5_resnet_vqa_tpu.data.okvqa import OkVqaCollate as JaxOkvqaCollate
from t5_resnet_vqa_tpu.data.okvqa import (
    OkVqaTrainableDataset as JaxTrainable,
)
from t5_resnet_vqa_tpu.data.synthetic import (
    make_synthetic_okvqa as jax_make_synthetic_okvqa,
)
from t5_resnet_vqa_tpu.train import VQATrainer as JaxTrainer
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import (
    DataLoader,
    OKVQADataset,
    OkVqaCollate,
    OkVqaTrainableDataset,
    load_answer_spaces,
    make_synthetic_okvqa,
)
from t5_resnet_vqa_torch.train import VQATrainer
from t5_resnet_vqa_torch.train.trainer import build_collates

import test_torch_trainer as cnn_case
from test_torch_resume import _jax_model_and_params

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("okvqa")
    kw = dict(num_train=8, num_test=6, num_images=4, image_size=48, seed=3)
    root, dk = make_synthetic_okvqa(str(tmp / "port"), **kw)
    jax_root, jax_dk = jax_make_synthetic_okvqa(str(tmp / "jax"), **kw)
    return dict(tmp=tmp, root=root, dk=dk, jax_root=jax_root, jax_dk=jax_dk)


def test_synthetic_corpus_matches_jax(corpus):
    files = []
    for base, _, names in os.walk(corpus["jax_root"]):
        files += [os.path.relpath(os.path.join(base, n), corpus["jax_root"])
                  for n in names]
    assert len(files) == 2 * 2 + 2 * 4 + 1
    for rel in files:
        with open(os.path.join(corpus["root"], rel), "rb") as f:
            got = f.read()
        with open(os.path.join(corpus["jax_root"], rel), "rb") as f:
            assert got == f.read(), rel
    assert {k: v for k, v in corpus["dk"].items() if k != "root_data_dir"} \
        == {k: v for k, v in corpus["jax_dk"].items()
            if k != "root_data_dir"}


def _split_files(corpus, split):
    dk = corpus["dk"]
    name = "train" if split == "train" else "test"
    with open(os.path.join(corpus["root"],
                           dk[f"{name}_annotations_json_fn"])) as f:
        ann = json.load(f)
    with open(os.path.join(corpus["root"],
                           dk[f"{name}_questions_json_fn"])) as f:
        qs = json.load(f)
    return ann, qs, os.path.join(corpus["root"], dk[f"{name}_images_dir"])


@pytest.mark.parametrize("split", ["train", "val"])
def test_datasets_match_jax(corpus, split):
    ann, qs, images = _split_files(corpus, split)
    ours, theirs = (OKVQADataset(ann, qs, images, split),
                    JaxOkvqaDataset(ann, qs, images, split))
    assert len(ours) == len(theirs) == (8 if split == "train" else 6)
    assert ours.image_ids_to_fn == theirs.image_ids_to_fn
    for i in range(len(ours)):
        assert dataclasses.asdict(ours[i]) == dataclasses.asdict(theirs[i])
    dk = corpus["dk"]
    name = "train" if split == "train" else "test"
    args = (corpus["root"], dk[f"{name}_annotations_json_fn"],
            dk[f"{name}_questions_json_fn"], dk[f"{name}_images_dir"], split)
    ours, theirs = (OkVqaTrainableDataset.from_files(*args),
                    JaxTrainable.from_files(*args))
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert len(got.annotation.answers) == 10


@pytest.mark.parametrize("use_native", [True, False])
def test_collate_matches_jax(corpus, use_native):
    ann, qs, images = _split_files(corpus, "train")
    samples = [OKVQADataset(ann, qs, images)[i] for i in range(5)]
    jax_samples = [JaxOkvqaDataset(ann, qs, images)[i] for i in range(5)]
    kw = dict(resizing_dimensions=(40, 40), eval_mode=True,
              use_native=use_native)
    got = OkVqaCollate(**kw)(samples)
    want = JaxOkvqaCollate(**kw)(jax_samples)
    assert set(got) == set(want)
    assert got["annotation_ids"].shape == (5, 10, 20)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, key
            assert got[key].tobytes() == w.tobytes(), key
        elif key == "questions":
            assert [dataclasses.asdict(q) for q in got[key]] == \
                [dataclasses.asdict(q) for q in w]
        else:
            assert got[key] == w, key


def _raw_config(corpus, root, dk, out_dir):
    raw = cnn_case._raw_config(root, dk, out_dir, epochs=1,
                               cache_frozen_features=True)
    raw["dataset_kwargs"]["image_size"] = 48
    return raw


@pytest.fixture(scope="module")
def runs(corpus):
    tmp = corpus["tmp"]
    answers = load_answer_spaces(os.path.join(corpus["root"],
                                              "answer_spaces.txt"))
    jmodel, params = _jax_model_and_params("cnn", len(answers))
    out = {}
    for name in ("jax", "port"):
        root = corpus["jax_root" if name == "jax" else "root"]
        dk = corpus["jax_dk" if name == "jax" else "dk"]
        raw = _raw_config(corpus, root, dk, tmp / f"{name}_out")
        path = os.path.join(str(tmp), f"{name}.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        if name == "jax":
            trainer = JaxTrainer(jmodel, JaxConfig.from_json(path), answers,
                                 params=jax.tree_util.tree_map(np.array,
                                                               params))
        else:
            trainer = VQATrainer(cnn_case._port_model(len(answers), params),
                                 Config.from_json(path), answers)
            labels = []
            step = trainer.train_step

            def recording(batch, step=step):
                labels.append(batch["annotation_ids"].numpy().copy())
                return step(batch)
            trainer.train_step = recording
            out["labels"] = labels
            out["config"] = Config.from_json(path)
        trainer.train()
        out[name] = tmp / f"{name}_out"
    out["answers"] = answers
    return out


def test_trainer_losses_match_jax(runs):
    for key in ("train_avg_loss", "valid_avg_loss"):
        got = cnn_case._records(runs["port"], key)
        want = cnn_case._records(runs["jax"], key)
        assert len(got) == len(want) == 1, key
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0,
                                   err_msg=key)
    got = cnn_case._predictions(runs["port"], 0)
    want = cnn_case._predictions(runs["jax"], 0)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g["prediction"], g["target"]) == (w["prediction"],
                                                  w["target"])


def test_trainer_log_and_labels(runs):
    log = cnn_case._log(runs["port"])
    line = ("Dataset: OK-VQA (COCO-style), 8 train / 6 val questions, "
            "10-annotator-answer grid -> fresh-answer sampling")
    assert line in log and line in cnn_case._log(runs["jax"])
    assert "Frozen-feature cache: off" not in log
    assert "Frozen-feature cache: " in log
    # the labels the steps took: the replayed loader's (same seed), each
    # one of its question's 10 annotator answers
    cfg, answers = runs["config"], runs["answers"]
    dk = cfg.dataset
    dataset = OkVqaTrainableDataset.from_files(
        dk.root_data_dir, dk.train_annotations_json_fn,
        dk.train_questions_json_fn, dk.train_images_dir, "train")
    collate, _ = build_collates(dk, answers, cfg.trainer.seed)
    collate.emit_images = False
    replay = list(DataLoader(dataset, collate, 4, shuffle=True,
                             seed=cfg.trainer.seed))
    assert len(runs["labels"]) == len(replay) == 2
    for labels, batch in zip(runs["labels"], replay):
        np.testing.assert_array_equal(labels, batch["annotation_ids"])
        for label, row in zip(labels, batch["_indices"]):
            grid = dataset[int(row)].annotation.answers
            assert answers[int(label)] in grid
