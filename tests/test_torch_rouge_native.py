"""ROUGE and the native image resize of the port against the JAX package.

* ``compute_rouge_metric`` on seeded predictions over a multi-word answer
  space equals the JAX package's (both stem with nltk's PorterStemmer,
  which imports here).
* The float image path (``uint8_wire_images=false``) with
  ``use_native_preprocessor=true``: the port's ``load_image_batch`` and
  both collates resize in fp32 through the port's own build of
  ``native/preproc.cpp`` and equal the JAX package's native output bit for
  bit, on two seeded PNG images (480x640 and 300x401) at 256^2 and 224^2,
  without and with mean = std = 0.5. They agree with cv2's uint8 resize
  within one uint8 step. A library that does not compile raises with the
  compiler's message instead of falling back to cv2.
"""

import os

import cv2
import numpy as np
import pytest

from t5_resnet_vqa_tpu.data.collate import DaquarCnnCollate as JaxCnnCollate
from t5_resnet_vqa_tpu.data.collate import DaquarVitCollate as JaxVitCollate
from t5_resnet_vqa_tpu.data.daquar import Annotation as JaxAnnotation
from t5_resnet_vqa_tpu.data.daquar import Question as JaxQuestion
from t5_resnet_vqa_tpu.data.daquar import Sample as JaxSample
from t5_resnet_vqa_tpu.data.preprocessing import (
    load_image_batch as jax_load_image_batch,
)
from t5_resnet_vqa_tpu.eval.rouge import compute_rouge_metric as jax_rouge
from t5_resnet_vqa_tpu.native import loader as jax_native
from t5_resnet_vqa_torch.data import (
    Annotation,
    DaquarCnnCollate,
    DaquarVitCollate,
    Question,
    Sample,
)
from t5_resnet_vqa_torch.data.preprocessing import load_image_batch
from t5_resnet_vqa_torch.eval.rouge import compute_rouge_metric, stemming_active
from t5_resnet_vqa_torch.native import loader

SOURCES = [(480, 640), (300, 401)]
SIZES = [256, 224]
HALF = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))


def test_rouge_matches_jax():
    rng = np.random.default_rng(0)
    words = ["table", "tables", "chair", "running", "runs", "lamp", "red",
             "blue", "books", "book", "cups"]
    answers = [" ".join(rng.choice(words, int(rng.integers(1, 4))))
               for _ in range(40)] + ["O", "two chairs", "a running lamp"]
    preds = rng.integers(0, len(answers), 200).tolist()
    targets = rng.integers(0, len(answers), 200).tolist()
    _, got = compute_rouge_metric(preds, targets, answers)
    _, want = jax_rouge(preds, targets, answers)
    assert stemming_active()
    assert {k: dict(v) for k, v in got.items()} == \
        {k: dict(v) for k, v in want.items()}
    assert got["rouge1"]["fmeasure"] > 0.0


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    paths = []
    for i, hw in enumerate(SOURCES):
        path = str(tmp / f"img{i}.png")
        cv2.imwrite(path, rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        paths.append(path)
    assert jax_native.get_lib() is not None, "the JAX native library"
    return paths


@pytest.mark.parametrize("normalize", [None, HALF], ids=["plain", "half"])
@pytest.mark.parametrize("size", SIZES)
def test_native_resize_matches_jax_bit_for_bit(images, size, normalize):
    kw = dict(size=(size, size), interpolation_strategy="bilinear_interpolation",
              normalize=normalize, use_native=True, emit_uint8=False)
    got = load_image_batch(images, **kw)
    want = jax_load_image_batch(images, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (len(images), size, size, 3)
    assert got.tobytes() == want.tobytes()
    # the cv2 path resizes in uint8: within one uint8 step of it
    cv2_path = load_image_batch(images, **dict(kw, use_native=False))
    scale = 1.0 if normalize is None else 2.0        # 1 / std
    np.testing.assert_allclose(got, cv2_path, rtol=0,
                               atol=scale * (1.0 / 255) + 1e-6)
    assert not np.array_equal(got, cv2_path)


def _samples(module, paths):
    q, a, s = ((Question, Annotation, Sample) if module == "port"
               else (JaxQuestion, JaxAnnotation, JaxSample))
    return [s(q(f"what is on the table {i}", f"img{i}", f"img{i}"),
              a(f"img{i}", f"img{i}", ["table"]), p)
            for i, p in enumerate(paths)]


@pytest.mark.parametrize("family", ["cnn", "vit"])
def test_float_collates_take_the_native_path(images, family):
    answers = ["table", "chair", "O"]
    if family == "cnn":
        kw = dict(resizing_dimensions=(256, 256), eval_mode=True,
                  use_native=True, emit_uint8=False)
        ours, theirs, key = (DaquarCnnCollate(answers, **kw),
                             JaxCnnCollate(answers, **kw), "image_tensors")
    else:
        kw = dict(eval_mode=True, use_native=True, emit_uint8=False)
        ours, theirs, key = (DaquarVitCollate(answers, **kw),
                             JaxVitCollate(answers, **kw), "pixel_values")
    got = ours(_samples("port", images))[key]
    want = theirs(_samples("jax", images))[key]
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("use_native", [True, False])
def test_trainer_collates_follow_use_native_preprocessor(images, use_native):
    from t5_resnet_vqa_torch.core import Config
    from t5_resnet_vqa_torch.train.trainer import build_collates

    dk = Config().dataset
    dk.uint8_wire_images = False
    dk.use_native_preprocessor = use_native
    answers = ["table", "chair", "O"]
    collate, _ = build_collates(dk, answers, seed=0)
    want = JaxCnnCollate(answers, dk.interpolation_strategy,
                         resizing_dimensions=(dk.image_size, dk.image_size),
                         use_native=use_native, emit_uint8=False)
    got = collate(_samples("port", images))["image_tensors"]
    assert got.tobytes() == want(_samples("jax", images))[
        "image_tensors"].tobytes()


def test_a_library_that_does_not_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "preproc.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SOURCE", str(broken))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="preproc.cpp"):
        loader.get_lib()
    assert not os.listdir(tmp_path / "build") or all(
        not f.endswith(".so") for f in os.listdir(tmp_path / "build"))
