"""The port's training data path, metric and config against the JAX package.

* ``make_synthetic_daquar``: the same CSV and answer files for the same
  seed, pixel-equal images.
* ``DaquarDataset`` (csv module, no pandas): the same rows.
* ``DataLoader``: the same index order, ``_valid`` and ``_indices``, shuffle
  on and off, epoch after epoch; ``Prefetcher`` hands the batches on as
  tensors with the host labels beside them.
* The collates the trainer builds from ``DatasetConfig``: batches byte-equal
  to the JAX collates built as the JAX trainer builds them (cv2 path),
  uint8 and float images, train and eval.
* WUPS: the committed goldens, and the JAX functions on every answer pair
  of the synthetic answer space.
* ``Config.from_json`` with dotted overrides: ``to_dict()`` equals JAX's.
"""

import dataclasses
import hashlib
import json
import os
import threading

import cv2
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import DaquarCnnCollate as JaxCollate
from t5_resnet_vqa_tpu.data import DaquarDataset as JaxDataset
from t5_resnet_vqa_tpu.data import DataLoader as JaxLoader
from t5_resnet_vqa_tpu.data import daquar_vocab
from t5_resnet_vqa_tpu.data import load_answer_spaces as jax_answers
from t5_resnet_vqa_tpu.data import make_synthetic_daquar as jax_synthetic
from t5_resnet_vqa_tpu.eval import wups as jax_wups
from t5_resnet_vqa_tpu.utils import convert_time_to_readable_format as jax_fmt
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import (
    DaquarDataset,
    DataLoader,
    Prefetcher,
    load_answer_spaces,
    make_synthetic_daquar,
)
from t5_resnet_vqa_torch.eval import wups
from t5_resnet_vqa_torch.train.trainer import build_collates
from t5_resnet_vqa_torch.utils import convert_time_to_readable_format

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The same synthetic dataset written by both packages; images of
    another size than the model's, so that the resize does work."""
    roots = {}
    for name, make in (("jax", jax_synthetic), ("port", make_synthetic_daquar)):
        root = str(tmp_path_factory.mktemp(f"daquar_{name}"))
        roots[name] = make(root, num_train=14, num_test=6, num_images=5,
                           source_hw=(40, 52), seed=3)
    return roots


def test_synthetic_files_are_the_same(synth):
    (jroot, jkw), (proot, pkw) = synth["jax"], synth["port"]
    assert {k: v for k, v in jkw.items() if k != "root_data_dir"} == \
        {k: v for k, v in pkw.items() if k != "root_data_dir"}
    for name in ("train.csv", "test.csv", "answer_spaces.txt"):
        with open(os.path.join(jroot, name), "rb") as a, \
                open(os.path.join(proot, name), "rb") as b:
            assert a.read() == b.read(), name
    images = sorted(os.listdir(os.path.join(jroot, "images")))
    assert images == sorted(os.listdir(os.path.join(proot, "images")))
    assert len(images) == 5
    for f in images:
        a = cv2.imread(os.path.join(jroot, "images", f))
        b = cv2.imread(os.path.join(proot, "images", f))
        assert a.shape == (40, 52, 3)
        np.testing.assert_array_equal(a, b)


def _datasets(root, split):
    csv_file = f"{split}.csv"
    return (JaxDataset(root, csv_file, "images", split),
            DaquarDataset(root, csv_file, "images", split))


@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_rows_are_the_same(synth, split):
    root = synth["jax"][0]
    theirs, ours = _datasets(root, split)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        a, b = theirs[i], ours[i]
        assert dataclasses.asdict(b.question) == dataclasses.asdict(a.question)
        assert dataclasses.asdict(b.annotation) == \
            dataclasses.asdict(a.annotation)
        assert b.image_path == a.image_path
    path = os.path.join(root, "answer_spaces.txt")
    assert load_answer_spaces(path) == jax_answers(path)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (True, False),
                                          (False, False)])
def test_loader_order_and_padding_are_the_same(synth, shuffle, drop):
    theirs_ds, ours_ds = _datasets(synth["jax"][0], "train")

    def ids(samples):
        return {"idx": [s.question.question_id for s in samples]}

    theirs = JaxLoader(theirs_ds, ids, 4, shuffle=shuffle, seed=7,
                       drop_remainder=drop)
    ours = DataLoader(ours_ds, ids, 4, shuffle=shuffle, seed=7,
                      drop_remainder=drop)
    assert len(ours) == len(theirs) == (3 if drop else 4)
    for _ in range(3):                  # the shuffle advances every epoch
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert g["idx"] == w["idx"]
            assert g["_valid"] == w["_valid"]
            assert g["_valid"].dtype == w["_valid"].dtype
            np.testing.assert_array_equal(g["_indices"], w["_indices"])
            assert g["_indices"].dtype == w["_indices"].dtype
    if not drop:
        assert int(got[-1]["_valid"]) == 14 - 12


def _jax_collates(dk, answers, seed):
    """The JAX trainer's collates (trainer.py:275-291), cv2 path."""
    kw = dict(resizing_dimensions=(dk.image_size, dk.image_size),
              lang_model=dk.language_model_tokenizer, seed=seed,
              tokenizer=None, use_native=False,
              emit_uint8=dk.uint8_wire_images,
              reduced_decode=dk.reduced_decode, num_workers=dk.num_workers)
    return (JaxCollate(answers, dk.interpolation_strategy, **kw),
            JaxCollate(answers, dk.interpolation_strategy, eval_mode=True,
                       **kw))


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), key
        elif key == "questions":
            assert [dataclasses.asdict(q) for q in g] == \
                [dataclasses.asdict(q) for q in w]
        else:
            assert g == w, key


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("interpolation", ["bilinear_interpolation",
                                           "bicubic_interpolation"])
def test_trainer_collates_are_byte_equal_to_jax(synth, uint8, interpolation):
    root, kw = synth["jax"]
    overrides = [f"dataset_kwargs.{k}={json.dumps(v)}" for k, v in {
        "root_data_dir": root, "image_size": 32, "uint8_wire_images": uint8,
        "interpolation_strategy": interpolation,
        "use_native_preprocessor": False}.items()]
    path = os.path.join(REPO, "vit_daquar_config.json")
    dk = Config.from_json(path, overrides).dataset
    jdk = JaxConfig.from_json(path, overrides).dataset
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    ours = build_collates(dk, answers, seed=5)
    theirs = _jax_collates(jdk, answers, seed=5)
    for split, (our_collate, their_collate) in zip(
            ("train", "test"), zip(ours, theirs)):
        their_ds, our_ds = _datasets(root, split)
        loaders = [DataLoader(our_ds, our_collate, 4, shuffle=True, seed=1,
                              drop_remainder=False),
                   JaxLoader(their_ds, their_collate, 4, shuffle=True,
                             seed=1, drop_remainder=False)]
        for _ in range(2):              # the answer choice advances too
            for got, want in zip(*map(list, loaders)):
                assert got["image_tensors"].shape == (4, 32, 32, 3)
                _assert_batches_equal(got, want)


def test_prefetcher_hands_on_tensors_and_errors(synth):
    root = synth["port"][0]
    ds = DaquarDataset(root, "train.csv", "images", "train")
    answers = load_answer_spaces(os.path.join(root, "answer_spaces.txt"))
    collate, _ = build_collates(Config().dataset, answers, seed=0)
    collate.resizing_dimensions = (16, 16)
    loader = DataLoader(ds, collate, 4, shuffle=True, seed=2)
    plain = list(DataLoader(ds, collate, 4, shuffle=True, seed=2))
    fetched = list(Prefetcher(loader, 2, torch.device("cpu")))
    assert len(fetched) == len(plain) == 3
    for got, want in zip(fetched, plain):
        for key in ("image_tensors", "question_input_ids", "annotation_ids"):
            assert isinstance(got[key], torch.Tensor)
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        np.testing.assert_array_equal(got["_host_annotation_ids"],
                                      want["annotation_ids"])
        assert isinstance(got["_indices"], np.ndarray)

    def broken():
        yield {"annotation_ids": np.zeros(2, np.int32)}
        raise ValueError("collate failed")

    with pytest.raises(ValueError, match="collate failed"):
        list(Prefetcher(broken(), 1))

    # a consumer that stops early releases the producer thread
    before = threading.active_count()
    it = iter(Prefetcher(({"i": np.arange(3)} for _ in range(100)), 1))
    next(it)
    it.close()
    assert threading.active_count() == before


def test_wups_matches_goldens_and_jax(synth):
    assert wups.wups_mode() == jax_wups.wups_mode() == "mini-wordnet"
    golden = json.load(open(os.path.join(REPO, "tests", "goldens",
                                         "wups_goldens.json")))
    words = sorted(set(daquar_vocab.ANSWER_WORDS))
    assert len(words) == golden["n_words"]
    h = hashlib.sha256()
    for a in words:
        for b in words:
            h.update(f"{a}|{b}|{round(wups.wup_measure(a, b), 6):.6f};"
                     .encode())
    assert h.hexdigest() == golden["matrix_sha256"]
    for pair, want in golden["explicit"].items():
        a, b = pair.split("|")
        assert wups.wup_measure(a, b) == pytest.approx(want, abs=1e-6), pair

    answers = load_answer_spaces(
        os.path.join(synth["port"][0], "answer_spaces.txt"))
    for a in answers:
        for b in answers:
            assert wups.wup_measure(a, b) == jax_wups.wup_measure(a, b)
    preds, targets = answers * 2, answers[::-1] * 2
    assert wups.average_wups(preds, targets) == \
        jax_wups.average_wups(preds, targets)


def test_config_and_time_format_match_jax():
    path = os.path.join(REPO, "vit_daquar_config.json")
    overrides = ["trainer_kwargs.epochs=3", "trainer.device=cpu",
                 "dataset_kwargs.train_batch_size=64",
                 "optimizer_kwargs.lm_encoder_lr=0.001",
                 "model.compute_dtype=float32",
                 "callbacks_kwargs.patience=7",
                 "lr_scheduler.num_warmup_steps=5"]
    ours = Config.from_json(path, overrides)
    theirs = JaxConfig.from_json(path, overrides)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.trainer.epochs == 3 and ours.callbacks.patience == 7
    assert Config().to_dict() == JaxConfig().to_dict()
    with pytest.raises(ValueError):
        Config.from_json(path, ["trainer.no_such_field=1"])
    assert ours.lr_scheduler.resolve_warmup(100) == 5
    assert Config().lr_scheduler.resolve_warmup(100) == 10
    for seconds in (0.5, 59.99, 61, 3725.4, 90061):
        assert convert_time_to_readable_format(seconds) == jax_fmt(seconds)
