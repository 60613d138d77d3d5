"""The port's ``VQATrainer``, ``VQAInferenceSession`` and entry points on
the Faster-RCNN and cross-attention families, against the JAX package's.

A 2-epoch run on synthetic DAQUAR (16 train questions, 6 test questions so
that the last eval batch is padded, 6 images) in both packages from the
same initial params, dropout 0, the cv2 image path:

* Faster-RCNN: the small model of ``test_torch_faster_rcnn.py`` (ResNet-50
  body + FPN 16, T5 d_model 32 with one layer over the T5 vocabulary,
  one SGA block) on 64x64 images, the CNN collate, the frozen-feature
  cache on (the config's default): both trainers cache the same ``pool``
  features (1e-5).
* Cross-attention: ViT hidden 32, one layer, 224x224 images in 16x16
  patches (the ViT collate's size: 197 image tokens) x a one-layer
  RoBERTa of hidden 32 over the T5 vocabulary, the ViT collate; the cache
  stays off with JAX's reason line, and no adaptive question length.

Per-epoch train and validation losses within 3e-4 (the train-step
tolerance), the same validation predictions and WUPS, the log lines JAX
writes about the cache, and ``best-model.pt`` loads strictly. The JAX
trainer's ``best-model`` then goes through the port's weight bridge, and
both packages' ``from_checkpoint`` (their factories building the small
model) answer the same requests: log-probabilities within 1e-4.
``generate_batch`` raises in both, with the same message. The entry points
reach each family from its documented ``--set``.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.eval import VQAInferenceSession as JaxSession
from t5_resnet_vqa_tpu.models.cross_attention_vqa import (
    CrossAttentionVitVQAModel as JaxCross,
)
from t5_resnet_vqa_tpu.models.faster_rcnn_vqa import (
    FasterRcnnVQAModel as JaxFrcnn,
)
from t5_resnet_vqa_tpu.models.roberta import RobertaConfig as JaxRobertaConfig
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.train import VQATrainer as JaxTrainer
from t5_resnet_vqa_tpu.train import factory as jax_factory
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import load_answer_spaces
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import (
    CrossAttentionVitVQAModel,
    FasterRcnnVQAModel,
    RobertaConfig,
    T5Config,
    ViTConfig,
)
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train import __main__ as cnn_entry
from t5_resnet_vqa_torch.train import VQATrainer
from t5_resnet_vqa_torch.train import factory
from t5_resnet_vqa_torch.train import trainer as trainer_module
from t5_resnet_vqa_torch.train import vit as vit_entry
from t5_resnet_vqa_torch.utils import (
    cross_attention_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
)

import test_torch_cross_attention as cross_case
import test_torch_faster_rcnn as frcnn_case
from test_torch_session_checkpoint import _logprobs
from test_torch_vit_trainer import _log, _predictions, _records

torch.set_num_threads(4)

VIT_NAME = "google/vit-base-patch16-224-in21k"
HIDDEN = 32
T5_KW = dict(vocab_size=32128, d_model=HIDDEN, d_kv=8, d_ff=64,
             num_layers=1, num_decoder_layers=1, num_heads=4,
             dropout_rate=0.0)
SGA_KW = dict(hidden_size=HIDDEN, num_heads=4, ff_size=HIDDEN,
              dropout_rate=0.0)
FPN_CHANNELS = 16
VIT_KW = dict(hidden_size=HIDDEN, num_layers=1, num_heads=4, mlp_dim=64,
              patch_size=16, image_size=224)
ROBERTA_KW = dict(vocab_size=32128, hidden_size=HIDDEN, num_layers=1,
                  num_heads=4, intermediate_size=64,
                  max_position_embeddings=40, dropout_rate=0.0)
MODEL_KW = {"faster_rcnn": {"vision_model_name": "faster-rcnn"},
            "cross": {"vision_model_name": VIT_NAME,
                      "language_model_name": "roberta-base"}}
FACTORY_FAMILY = {"faster_rcnn": "cnn", "cross": "cross_attention"}
LOGPROB_TOL = 1e-4


def _raw_config(family, root, kw, out_dir, **trainer):
    return {
        "model_kwargs": dict(MODEL_KW[family]),
        "dataset_kwargs": dict(kw, root_data_dir=root, train_batch_size=4,
                               test_batch_size=4, image_size=64,
                               use_native_preprocessor=False),
        "trainer_kwargs": dict(dict(epochs=2, output_dir=str(out_dir),
                                    seed=0, device="cpu",
                                    load_from_checkpoint=False), **trainer),
        "optimizer_kwargs": {"type": "AdamW", "lm_encoder_lr": 1e-3,
                             "classifier_lr": 5e-3, "fusion_lr": 1e-3,
                             "default_lr": 1e-3,
                             "kwargs": {"weight_decay": 0.1,
                                        "amsgrad": True}},
        "callbacks_kwargs": {"kwargs": {"threshold": -1.0, "patience": 3}},
    }


def _write(tmp, raw, name):
    path = os.path.join(str(tmp), name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _jax_model(family, n):
    if family == "faster_rcnn":
        return JaxFrcnn(answer_spaces=n, t5_config=JaxT5Config(**T5_KW),
                        num_attention_blocks=1,
                        sga_config=JaxAttentionConfig(**SGA_KW),
                        fpn_channels=FPN_CHANNELS)
    return JaxCross(answer_spaces=n, vit_config=JaxViTConfig(**VIT_KW),
                    roberta_config=JaxRobertaConfig(**ROBERTA_KW))


def _port_model(family, n, params=None):
    if family == "faster_rcnn":
        model = FasterRcnnVQAModel(
            n, t5_config=T5Config(**T5_KW), num_attention_blocks=1,
            sga_config=AttentionConfig(**SGA_KW), fpn_channels=FPN_CHANNELS,
            device="cpu")
        bridge = lambda p: faster_rcnn_state_dict_from_jax(p, 1, 1)
    else:
        model = CrossAttentionVitVQAModel(
            n, vit_config=ViTConfig(**VIT_KW),
            roberta_config=dataclasses.replace(RobertaConfig(),
                                               **ROBERTA_KW),
            device="cpu")
        bridge = lambda p: cross_attention_state_dict_from_jax(p, 1)
    if params is not None:
        model.load_state_dict(bridge(params), strict=True)
    return model


def _jax_params(family, model):
    rng = np.random.default_rng(0)
    ids = np.ones((2, 16), np.int32)
    if family == "faster_rcnn":
        batch = dict(question_input_ids=ids, question_attention_masks=ids,
                     image_tensors=np.zeros((2, 64, 64, 3), np.uint8))
        return frcnn_case.init_params(model, rng, batch)
    return cross_case.init_params(model, rng, dict(
        question_input_ids=ids,
        pixel_values=np.zeros((2, 224, 224, 3), np.uint8)))


def _cache_line(log):
    return next(line[line.index("Frozen-feature cache:"):]
                for line in log.splitlines()
                if "Frozen-feature cache:" in line)


@pytest.fixture(scope="module", params=["faster_rcnn", "cross"])
def runs(request, tmp_path_factory):
    family = request.param
    tmp = tmp_path_factory.mktemp(f"trainer_{family}")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=16,
                                     num_test=6, image_size=64)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    jmodel = _jax_model(family, len(answers))
    params = _jax_params(family, jmodel)
    out, trainers = {}, {}
    for name in ("jax", "port"):
        out_dir = tmp / name
        path = _write(tmp, _raw_config(family, root, kw, out_dir),
                      f"{name}.json")
        if name == "jax":
            trainer = JaxTrainer(jmodel, JaxConfig.from_json(path), answers,
                                 params=jax.tree_util.tree_map(np.array,
                                                               params))
        else:
            trainer = VQATrainer(_port_model(family, len(answers), params),
                                 Config.from_json(path), answers)
        trainer.train()
        out[name], trainers[name] = out_dir, trainer
    return dict(family=family, out=out, trainers=trainers, root=root, kw=kw,
                answers=answers, tmp=tmp, jmodel=jmodel)


def test_losses_and_wups_match_jax(runs):
    jax_dir, port_dir = runs["out"]["jax"], runs["out"]["port"]
    for key in ("train_avg_loss", "valid_avg_loss"):
        got, want = _records(port_dir, key), _records(jax_dir, key)
        assert len(got) == len(want) == 2, key
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4,
                                   err_msg=key)
    for key in ("train_avg_wups", "valid_avg_wups"):
        assert _records(port_dir, key) == pytest.approx(
            _records(jax_dir, key), abs=1e-9), key
    for epoch in (0, 1):
        got = _predictions(port_dir, epoch)
        want = _predictions(jax_dir, epoch)
        assert len(got) == len(want) == 6          # padding rows dropped
        for g, w in zip(got, want):
            assert (g["prediction"], g["target"]) == \
                (w["prediction"], w["target"])


def test_cache_and_log_lines_match_jax(runs):
    port, jx = runs["trainers"]["port"], runs["trainers"]["jax"]
    log, jax_log = _log(runs["out"]["port"]), _log(runs["out"]["jax"])
    for line in ("Start Training: Max Epoch 2", "Average WUPS Score",
                 "Saving new best-model with F-Score"):
        assert line in log and line in jax_log, line
    assert "Adaptive token lengths" not in log + jax_log
    if runs["family"] == "cross":
        want = ("Frozen-feature cache: off (CrossAttentionVitVQAModel has "
                "no separable frozen tower)")
        assert _cache_line(log) == _cache_line(jax_log) == want
        assert port._feature_cache is None and jx._feature_cache is None
        assert "pixel_values" in next(iter(port.train_dataloader))
        return
    assert _cache_line(log).startswith("Frozen-feature cache: 6 images, ")
    assert _cache_line(jax_log).startswith("Frozen-feature cache: 6 images, ")
    assert port._feature_cache.path_to_slot == jx._feature_cache.path_to_slot
    features = port._feature_cache.features
    assert tuple(features.shape) == (6, 1, 1, FPN_CHANNELS)
    np.testing.assert_allclose(features.numpy(),
                               np.asarray(jx._feature_cache.features),
                               rtol=1e-5, atol=1e-5)
    batch = next(iter(port.train_dataloader))
    assert "image_tensors" not in batch and "vision_features" in batch


def test_best_model_loads_strictly(runs):
    path = os.path.join(str(runs["out"]["port"]), "model_checkpoints",
                        "best-model.pt")
    saved = torch.load(path, weights_only=True)
    fresh = _port_model(runs["family"], len(runs["answers"]))
    fresh.load_state_dict(saved, strict=True)
    for key, value in runs["trainers"]["port"].model.state_dict().items():
        assert torch.equal(value, saved[key]), key


def test_sessions_from_checkpoint_match_jax(runs, monkeypatch):
    family, tmp, answers = runs["family"], runs["tmp"], runs["answers"]
    # the JAX trainer's best-model, through the port's weight bridge
    from t5_resnet_vqa_tpu.train.callbacks import CheckpointManager
    best = jax.tree_util.tree_map(np.asarray, CheckpointManager(
        str(runs["out"]["jax"])).restore_tree("best-model"))
    dst = tmp / "served" / "model_checkpoints"
    os.makedirs(dst)
    torch.save(_port_model(family, len(answers), best).state_dict(),
               dst / "best-model.pt")
    shutil.copy(os.path.join(str(runs["out"]["jax"]), "model_checkpoints",
                             "model_ckpt_info.json"), dst)

    monkeypatch.setattr(jax_factory, "build_model",
                        lambda cfg, n: (runs["jmodel"],
                                        FACTORY_FAMILY[family]))
    monkeypatch.setattr(factory, "build_model",
                        lambda cfg, n, device=None, generator=None:
                        (_port_model(family, n), FACTORY_FAMILY[family]))
    jax_session = JaxSession.from_checkpoint(JaxConfig.from_json(_write(
        tmp, _raw_config(family, runs["root"], runs["kw"],
                         runs["out"]["jax"]), "jax_serve.json")),
        batch_size=4)
    port_session = VQAInferenceSession.from_checkpoint(Config.from_json(
        _write(tmp, _raw_config(family, runs["root"], runs["kw"],
                                tmp / "served"), "port_serve.json")),
        batch_size=4, device="cpu")
    assert port_session.family == FACTORY_FAMILY[family]
    images_dir = os.path.join(runs["root"], runs["kw"]["images_dir"])
    images = sorted(os.path.join(images_dir, f)
                    for f in os.listdir(images_dir))
    # 6 requests through a batch of 4: the second chunk is padded
    reqs = [(images[i % len(images)], f"what is on the table {i}")
            for i in range(6)]
    want = jax_session.ask_batch(reqs, top_k=len(answers))
    got = port_session.ask_batch(reqs, top_k=len(answers))
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    np.testing.assert_allclose(_logprobs(got, answers),
                               _logprobs(want, answers), rtol=0,
                               atol=LOGPROB_TOL)
    single = port_session.ask(*reqs[1], top_k=2)
    assert single["top_answers"] == got[1]["top_answers"][:2]

    with pytest.raises(ValueError) as jax_err:
        jax_session.generate_batch(reqs[:1])
    with pytest.raises(ValueError) as port_err:
        port_session.generate_batch(reqs[:1])
    for err in (jax_err, port_err):
        assert "generate_batch needs the ViT enc" in str(err.value)
        assert repr(FACTORY_FAMILY[family]) in str(err.value)


def test_entry_point_reaches_the_family(runs, tmp_path, monkeypatch):
    family = runs["family"]
    built = []

    def small_model(model_cfg, num_answers, device=None, generator=None):
        built.append((model_cfg.vision_model_name,
                      model_cfg.language_model_name,
                      factory.model_family(model_cfg)))
        return _port_model(family, num_answers), built[-1][2]

    monkeypatch.setattr(trainer_module, "build_model", small_model)
    raw = _raw_config(family, runs["root"], runs["kw"], tmp_path / "out",
                      epochs=1)
    raw["model_kwargs"] = {"vision_model_name": "resnet18"}
    path = _write(tmp_path, raw, "config.json")
    if family == "faster_rcnn":
        cnn_entry.main(["--config", path, "--set",
                        "model_kwargs.vision_model_name=faster-rcnn",
                        "--set", "trainer_kwargs.device=cpu"])
        assert built == [("faster-rcnn", "t5-base", "cnn")]
    else:
        vit_entry.main(["--config", path, "--set",
                        "model_kwargs.language_model_name=roberta-base",
                        "--set", "trainer_kwargs.device=cpu"])
        assert built == [(VIT_NAME, "roberta-base", "cross_attention")]
    assert os.path.exists(tmp_path / "out" / "model_checkpoints" /
                          "best-model.pt")
    assert len(_predictions(tmp_path / "out", 0)) == 6
