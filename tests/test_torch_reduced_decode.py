"""Reduced image decoding and the decode thread pool of the port against
the JAX package.

* ``load_image_batch`` with ``reduce`` in {0, 2, 4} x ``workers`` in
  {0, 4} x the uint8 wire, the fp32 native resize and the fp32 cv2 resize
  equals JAX's bit for bit, on three seeded images: a 480x640 JPEG (whose
  reduced decode is libjpeg's DCT scaling), a 300x401 PNG and a 97x131
  PNG.
* Both collates with ``reduced_decode`` and ``num_workers`` give JAX's
  batches bit for bit, and the trainer's collates take both knobs from the
  dataset config (``build_collates``).
* ``VQATrainer`` accepts ``reduced_decode=2``: its first batch equals the
  JAX trainer's collate's. (``from_checkpoint`` with ``reduced_decode=2``
  is held against JAX's in ``tests/test_torch_session_checkpoint.py``.)
"""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.data.collate import DaquarCnnCollate as JaxCnnCollate
from t5_resnet_vqa_tpu.data.collate import DaquarVitCollate as JaxVitCollate
from t5_resnet_vqa_tpu.data.daquar import Annotation as JaxAnnotation
from t5_resnet_vqa_tpu.data.daquar import Question as JaxQuestion
from t5_resnet_vqa_tpu.data.daquar import Sample as JaxSample
from t5_resnet_vqa_tpu.data.preprocessing import (
    load_image_batch as jax_load_image_batch,
)
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import (
    Annotation,
    DaquarCnnCollate,
    DaquarVitCollate,
    Question,
    Sample,
    load_answer_spaces,
)
from t5_resnet_vqa_torch.data.preprocessing import load_image_batch
from t5_resnet_vqa_torch.train import VQATrainer
from t5_resnet_vqa_torch.train.trainer import build_collates

import test_torch_trainer as cnn_case

REDUCE = (0, 2, 4)
WORKERS = (0, 4)
PATHS = {"uint8": dict(emit_uint8=True, use_native=False),
         "fp32_native": dict(emit_uint8=False, use_native=True),
         "fp32_cv2": dict(emit_uint8=False, use_native=False)}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reduced")
    rng = np.random.default_rng(7)
    paths = []
    for name, (h, w) in (("a.jpg", (480, 640)), ("b.png", (300, 401)),
                         ("c.png", (97, 131))):
        # smooth content, so that the JPEG's DCT scaling has work to do
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        path = str(tmp / name)
        assert cv2.imwrite(path, img)
        paths.append(path)
    return paths


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("reduce", REDUCE)
def test_load_image_batch_matches_jax(images, reduce, workers, path):
    kw = dict(PATHS[path], normalize=((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
              reduce=reduce, workers=workers)
    got = load_image_batch(images, (96, 64), **kw)
    want = jax_load_image_batch(images, (96, 64), **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 64, 96, 3)
    assert got.tobytes() == want.tobytes()
    if reduce:      # the knob changes the pixels
        full = load_image_batch(images, (96, 64), **dict(kw, reduce=0))
        assert full.tobytes() != got.tobytes()


def _samples(module, paths):
    Q, A, S = module
    return [S(Q(f"what is on the table {i}", f"q{i}", f"i{i}"),
              A(f"q{i}", f"i{i}", ["red", "blue"]), p)
            for i, p in enumerate(paths)]


@pytest.mark.parametrize("family", ["cnn", "vit"])
@pytest.mark.parametrize("reduce", (2, 4))
def test_collates_match_jax(images, family, reduce):
    answers = ["blue", "red", "O"]
    kw = dict(eval_mode=True, reduced_decode=reduce, num_workers=3,
              seed=3)
    for uint8 in (True, False):
        if family == "cnn":
            ours = DaquarCnnCollate(answers, "bicubic_interpolation",
                                    (40, 40), emit_uint8=uint8, **kw)
            theirs = JaxCnnCollate(answers, "bicubic_interpolation",
                                   (40, 40), emit_uint8=uint8, **kw)
            key = "image_tensors"
        else:
            ours = DaquarVitCollate(answers, emit_uint8=uint8, **kw)
            theirs = JaxVitCollate(answers, emit_uint8=uint8, **kw)
            key = "pixel_values"
        got = ours(_samples((Question, Annotation, Sample), images))
        want = theirs(_samples((JaxQuestion, JaxAnnotation, JaxSample),
                               images))
        for k in (key, "annotation_ids", "question_input_ids"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reduced_trainer")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=8,
                                     num_test=4, image_size=64,
                                     source_hw=(120, 160))
    return tmp, root, kw


def test_build_collates_take_the_knobs(synth):
    _, root, kw = synth
    overrides = [f"dataset_kwargs.{k}={json.dumps(v)}" for k, v in {
        "root_data_dir": root, "reduced_decode": 4, "num_workers": 3}.items()]
    dk = Config.from_json(os.path.join(cnn_case.REPO,
                                       "vit_daquar_config.json"),
                          overrides).dataset
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    for family in ("cnn", "vit"):
        for collate in build_collates(dk, answers, seed=0, family=family):
            assert (collate.reduced_decode, collate.num_workers) == (4, 3)


def test_trainer_accepts_reduced_decode(synth):
    tmp, root, kw = synth
    raw = cnn_case._raw_config(root, kw, tmp / "out")
    raw["dataset_kwargs"].update(reduced_decode=2, num_workers=2)
    path = cnn_case._write(tmp, raw)
    cfg = Config.from_json(path)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    trainer = VQATrainer(cnn_case._port_model(len(answers)), cfg, answers)
    collate = trainer.train_dataloader.collate_fn
    assert (collate.reduced_decode, collate.num_workers) == (2, 2)
    jdk = JaxConfig.from_json(path).dataset
    theirs = JaxCnnCollate(answers, jdk.interpolation_strategy,
                           resizing_dimensions=(64, 64), seed=0,
                           use_native=False,
                           emit_uint8=jdk.uint8_wire_images,
                           reduced_decode=2, num_workers=2)
    ds = trainer.train_dataloader.dataset
    samples = [ds[i] for i in range(4)]
    jax_samples = [JaxSample(JaxQuestion(**dataclasses.asdict(s.question)),
                             JaxAnnotation(**dataclasses.asdict(
                                 s.annotation)), s.image_path)
                   for s in samples]
    got = collate(samples)["image_tensors"]
    want = theirs(jax_samples)["image_tensors"]
    assert got.shape == (4, 64, 64, 3)
    assert got.tobytes() == want.tobytes()
