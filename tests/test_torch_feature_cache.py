"""The port's frozen-feature cache (``train/feature_cache.py``) against the
JAX package's, and against the port's own image-fed path.

* Model level, for a small CNN-family model (ResNet-18 + T5 d_model 32 with
  one layer + one SGA block of hidden 32) and the small ViT family model of
  ``test_torch_vit_train_step.py``, both from JAX params: the cache's
  features equal the JAX ``compute_vision_features`` of the same images,
  and a forward fed the gathered features equals the image-fed forward,
  log-probs and loss within rtol/atol 1e-5 (``tests/test_feature_cache.py``'s
  tolerance for the JAX cache). Five images in chunks of 4: the tail chunk
  is padded.
* ``collect_image_slots`` gives JAX's unique paths and row maps on the same
  synthetic DAQUAR.
* Trainer level: a one-epoch run with the cache on reproduces the run with
  it off, train and validation losses within rtol 2e-4
  (``tests/test_feature_cache.py:141``), for both families (the ViT at
  224x224 in 16x16 patches, the ViT collate's size, hidden 32, one layer).
* Each of the four reasons to leave the cache off logs its line, and so do
  the size cap and an empty dataset.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from t5_resnet_vqa_tpu.data import DaquarDataset as JaxDataset
from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxResnet
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.train.feature_cache import (
    collect_image_slots as jax_collect,
)
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import (
    Annotation,
    DaquarDataset,
    Question,
    Sample,
    load_answer_spaces,
    make_synthetic_daquar,
)
from t5_resnet_vqa_torch.models import (
    ResnetVQAModel,
    T5Config,
    ViTConfig,
    VitVQAModel,
)
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train import (
    VQATrainer,
    build_feature_cache,
    collect_image_slots,
)
from t5_resnet_vqa_torch.utils import state_dict_from_jax

from test_torch_train_step import _random_params
from test_torch_vit_train_step import (
    jax_vit_model,
    jax_vit_params,
    make_batch,
    port_vit_model,
)

torch.set_num_threads(4)

TOL = dict(rtol=1e-5, atol=1e-5)
ANSWERS = 13
N_IMAGES = 5
CNN_T5 = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
              num_decoder_layers=1, num_heads=4, dropout_rate=0.0)
CNN_SGA = dict(hidden_size=32, num_heads=4, ff_size=32, dropout_rate=0.0)
# the trainer runs: the hash tokenizer's ids span the T5 vocabulary, and the
# ViT collate resizes to 224x224
TRAIN_T5 = dict(CNN_T5, vocab_size=32128)
TRAIN_VIT = dict(hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64,
                 patch_size=16, image_size=224)
VIT_NAME = "google/vit-base-patch16-224-in21k"


def _samples(paths):
    return [Sample(Question(f"what is on the table {i}", f"q{i}", p),
                   Annotation(f"a{i}", p, ["table"]), p)
            for i, p in enumerate(paths)]


def _cnn_pair(rng):
    jmodel = JaxResnet(answer_spaces=ANSWERS, vision_model_name="resnet18",
                       t5_config=JaxT5Config(**CNN_T5),
                       sga_config=JaxAttentionConfig(**CNN_SGA),
                       num_attention_blocks=1)
    batch = dict(question_input_ids=np.ones((2, 16), np.int32),
                 question_attention_masks=np.ones((2, 16), np.int32),
                 image_tensors=np.zeros((2, 64, 64, 3), np.uint8))
    params = _random_params(jmodel, batch, rng)
    model = ResnetVQAModel(ANSWERS, vision_model_name="resnet18",
                           t5_config=T5Config(**CNN_T5),
                           num_attention_blocks=1,
                           sga_config=AttentionConfig(**CNN_SGA),
                           device="cpu")
    model.load_state_dict(state_dict_from_jax(params, "resnet18", 1, 1),
                          strict=True)
    return jmodel, params, model.eval(), 64, "image_tensors"


def _vit_pair(rng):
    jmodel = jax_vit_model()
    params = jax_vit_params(jmodel, rng, make_batch(rng))
    return jmodel, params, port_vit_model(params).eval(), 32, "pixel_values"


@pytest.mark.parametrize("family", ["cnn", "vit"])
def test_cached_forward_matches_image_fed_forward(family):
    rng = np.random.default_rng(0)
    jmodel, params, model, size, key = (_cnn_pair if family == "cnn"
                                        else _vit_pair)(rng)
    paths = [f"img{i}.png" for i in range(N_IMAGES)]
    pixels = {p: rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for p in paths}
    loaded = []

    def load_images(chunk):
        loaded.append(len(chunk))
        return np.stack([pixels[p] for p in chunk])

    # the train rows use images 0-3 twice, the test rows image 4 and 0
    train = _samples([paths[i % 4] for i in range(8)])
    test = _samples([paths[4], paths[0]])
    (cache, (row_train, row_test), _), why = build_feature_cache(
        model, [train, test], load_images, batch_size=4)
    assert why is None and loaded == [4, 4]          # the tail padded
    assert cache.features.shape[0] == N_IMAGES
    assert cache.features.dtype == torch.float32
    np.testing.assert_array_equal(row_train, [0, 1, 2, 3] * 2)
    np.testing.assert_array_equal(row_test, [4, 0])
    np.testing.assert_array_equal(cache.row_map(test), row_test)
    assert cache.nbytes == cache.features.numel() * 4

    images = np.stack([pixels[p] for p in paths])
    want = np.asarray(jmodel.compute_vision_features(params, images))
    np.testing.assert_allclose(cache.features.numpy(), want, **TOL)

    text = make_batch(rng, b=N_IMAGES)
    batch = {k: torch.from_numpy(v) for k, v in text.items()
             if k != "pixel_values"}
    if family == "cnn":
        for k in ("decoder_question_input_ids",
                  "decoder_question_attention_masks"):
            batch.pop(k)
    slots = np.array([4, 0, 3, 1, 2])
    with torch.no_grad():
        lp_img, loss_img = model(
            **batch, **{key: torch.from_numpy(images[slots])})
        lp_cache, loss_cache = model(**batch,
                                     vision_features=cache.gather(slots))
    np.testing.assert_allclose(lp_cache.numpy(), lp_img.numpy(), **TOL)
    np.testing.assert_allclose(float(loss_cache), float(loss_img), rtol=1e-5)


def test_image_slots_match_jax(tmp_path):
    root, kw = make_synthetic_daquar(str(tmp_path / "daquar"), num_train=16,
                                     num_test=6, image_size=32)
    ours = [DaquarDataset(root, kw[f"{s}_csv_file"], kw["images_dir"], s)
            for s in ("train", "test")]
    theirs = [JaxDataset(root, kw[f"{s}_csv_file"], kw["images_dir"], s)
              for s in ("train", "test")]
    paths, maps = collect_image_slots(ours)
    jpaths, jmaps = jax_collect(theirs)
    assert paths == jpaths and len(paths) == 6
    for a, b in zip(maps, jmaps):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_size_cap_and_empty_datasets_leave_the_cache_off():
    _, _, model, size, _ = _vit_pair(np.random.default_rng(1))
    samples = _samples(["a.png", "b.png"])

    def load_images(chunk):
        return np.zeros((len(chunk), size, size, 3), np.uint8)

    built, why = build_feature_cache(model, [samples], load_images,
                                     max_bytes=100)
    assert built is None and "exceeds" in why
    built, why = build_feature_cache(model, [[]], load_images)
    assert built is None and why == "datasets reference no images"


# ------------------------------------------------------------------ trainer

def _config(root, kw, out_dir, family, cache_on):
    raw = {
        "model_kwargs": {"vision_model_name": "resnet18" if family == "cnn"
                         else VIT_NAME},
        "dataset_kwargs": dict(kw, root_data_dir=root, train_batch_size=4,
                               test_batch_size=4, image_size=64,
                               use_native_preprocessor=False),
        "trainer_kwargs": dict(epochs=1, output_dir=str(out_dir), seed=0,
                               device="cpu", load_from_checkpoint=False,
                               cache_frozen_features=cache_on),
        "optimizer_kwargs": {"type": "AdamW", "lm_encoder_lr": 1e-3,
                             "lm_decoder_lr": 3e-4, "classifier_lr": 5e-3,
                             "fusion_lr": 1e-3, "vision_lr": 8e-3,
                             "kwargs": {"weight_decay": 0.1,
                                        "amsgrad": True}},
        "callbacks_kwargs": {"kwargs": {"threshold": -1.0, "patience": 3}},
    }
    path = os.path.join(str(out_dir) + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return Config.from_json(path)


def _train_model(family, num_answers, fine_tune_vision=False):
    g = torch.Generator().manual_seed(3)
    if family == "cnn":
        return ResnetVQAModel(num_answers, vision_model_name="resnet18",
                              t5_config=T5Config(**TRAIN_T5),
                              num_attention_blocks=1,
                              sga_config=AttentionConfig(**CNN_SGA),
                              fine_tune_vision=fine_tune_vision,
                              device="cpu", generator=g)
    return VitVQAModel(num_answers, t5_config=T5Config(**TRAIN_T5),
                       vit_config=ViTConfig(**TRAIN_VIT),
                       fine_tune_vision=fine_tune_vision, fusing_dropout=0.0,
                       device="cpu", generator=g)


def _log(out_dir):
    logs = [f for f in os.listdir(str(out_dir))
            if f.startswith("training_log_")]
    assert len(logs) == 1
    with open(os.path.join(str(out_dir), logs[0])) as f:
        return f.read()


def _losses(out_dir, key):
    with open(os.path.join(str(out_dir), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r[key] for r in rows if r.get("_event") == "log" and key in r]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cache")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=12,
                                     num_test=6, image_size=64)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    return dict(tmp=tmp, root=root, kw=kw, answers=answers)


@pytest.mark.parametrize("family", ["cnn", "vit"])
def test_cached_epoch_matches_uncached(data, family):
    runs = {}
    for cache_on in (False, True):
        out = data["tmp"] / f"{family}_cache_{cache_on}"
        cfg = _config(data["root"], data["kw"], out, family, cache_on)
        trainer = VQATrainer(_train_model(family, len(data["answers"])), cfg,
                             data["answers"])
        assert (trainer._feature_cache is not None) == cache_on
        trainer.train()
        if cache_on:            # after the run: a batch draws labels
            batch = next(iter(trainer.train_dataloader))
            assert "image_tensors" not in batch and "pixel_values" not in batch
            assert batch["vision_features"].shape[0] == 4
        runs[cache_on] = out
    log = _log(runs[True])
    assert "Frozen-feature cache: 6 images, " in log
    assert "built in" in log and "on cpu" in log
    assert "cache_frozen_features" not in log
    assert "Frozen-feature cache" not in _log(runs[False])
    for key in ("train_avg_loss", "valid_avg_loss"):
        got, want = _losses(runs[True], key), _losses(runs[False], key)
        assert len(got) == len(want) == 1, key
        np.testing.assert_allclose(got, want, rtol=2e-4, err_msg=key)


class _NoTower(nn.Module):
    """A model without ``compute_vision_features``."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, **batch):
        return self.inner(**batch)


class _RowsWithoutPaths:
    """Rows with a question and an annotation, and no ``image_path``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        s = self.dataset[i]
        return types.SimpleNamespace(question=s.question,
                                     annotation=s.annotation)


@pytest.mark.parametrize("reason", [
    "has no separable frozen tower", "vision tower is fine-tuned",
    "vision tower has stochastic regularization",
    "dataset rows carry no image_path"])
def test_each_reason_to_leave_the_cache_off_is_logged(data, reason,
                                                      monkeypatch):
    out = data["tmp"] / f"off_{reason.split()[-1]}"
    cfg = _config(data["root"], data["kw"], out, "vit", True)
    model = _train_model("vit", len(data["answers"]),
                         fine_tune_vision=reason.endswith("fine-tuned"))
    kwargs = {}
    if reason.startswith("has no"):
        model = _NoTower(model)
    elif reason.endswith("regularization"):
        monkeypatch.setattr(model, "vision_tower_deterministic",
                            lambda: False)
    elif reason.endswith("image_path"):
        dk = cfg.dataset
        kwargs["train_dataset"] = _RowsWithoutPaths(DaquarDataset(
            dk.root_data_dir, dk.train_csv_file, dk.images_dir, "train"))
    trainer = VQATrainer(model, cfg, data["answers"], **kwargs)
    assert trainer._feature_cache is None
    lines = [ln for ln in _log(out).splitlines()
             if "Frozen-feature cache" in ln]
    assert len(lines) == 1 and f"Frozen-feature cache: off (" in lines[0]
    assert reason in lines[0]
