"""The port's ``VQATrainer`` on the ViT family against the JAX package's
trainer, and the ViT entry point ``python -m t5_resnet_vqa_torch.train.vit``.

A 2-epoch run on synthetic DAQUAR (16 train questions, 6 test questions so
that the last eval batch is padded, 6 images) with a small ViT-family
model: ViT hidden 32 with one layer over 224x224 images in 16x16 patches
(the ViT collate's size), T5 d_model 32 with 1 + 1 layers over the T5
vocabulary (the hash tokenizer's ids span it), dropout 0 and fusing dropout
0, the cv2 image path on both sides, from the same initial params. Both
runs take the config's defaults: the frozen-feature cache on and the
adaptive question length. Per-epoch train and validation losses agree
within 3e-4 (the train-step tolerance), the validation predictions and
WUPS are the same, both trainers fit the same token lengths, and
``best-model.pt`` (the tied table under its four HF keys) loads strictly
and resumes.

The entry point trains one tiny epoch on the CPU when
``--set trainer_kwargs.device=cpu`` names it (in process, with the factory
building the small model, since a full-width model is too large for a CPU
test), builds a ViT-family model whatever vision model the config names,
and raises without a card otherwise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.models.vit_vqa import VitVQAModel as JaxModel
from t5_resnet_vqa_tpu.train import VQATrainer as JaxTrainer
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import load_answer_spaces
from t5_resnet_vqa_torch.models import T5Config, ViTConfig, VitVQAModel
from t5_resnet_vqa_torch.train import VQATrainer
from t5_resnet_vqa_torch.train import trainer as trainer_module
from t5_resnet_vqa_torch.train import vit as vit_entry
from t5_resnet_vqa_torch.utils import vit_state_dict_from_jax

torch.set_num_threads(4)

VIT_NAME = "google/vit-base-patch16-224-in21k"
VIT_KW = dict(hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64,
              patch_size=16, image_size=224)
T5_KW = dict(vocab_size=32128, d_model=32, d_kv=8, d_ff=64, num_layers=1,
             num_decoder_layers=1, num_heads=4, dropout_rate=0.0)
TIED_KEYS = ("shared", "encoder.embed_tokens", "decoder.embed_tokens",
             "lm_head")


def _raw_config(root, kw, out_dir, **trainer):
    return {
        "model_kwargs": {"vision_model_name": VIT_NAME},
        "dataset_kwargs": dict(kw, root_data_dir=root, train_batch_size=4,
                               test_batch_size=4,
                               use_native_preprocessor=False),
        "trainer_kwargs": dict(dict(epochs=2, output_dir=str(out_dir),
                                    seed=0, device="cpu",
                                    load_from_checkpoint=False), **trainer),
        "optimizer_kwargs": {"type": "AdamW", "lm_encoder_lr": 1e-3,
                             "lm_decoder_lr": 3e-4, "classifier_lr": 5e-3,
                             "fusion_lr": 1e-3,
                             "kwargs": {"weight_decay": 0.1,
                                        "amsgrad": True}},
        "callbacks_kwargs": {"kwargs": {"threshold": -1.0, "patience": 3}},
    }


def _write(tmp, raw, name="config.json"):
    path = os.path.join(str(tmp), name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _port_model(num_answers, params=None):
    model = VitVQAModel(num_answers, t5_config=T5Config(**T5_KW),
                        vit_config=ViTConfig(**VIT_KW), fusing_dropout=0.0,
                        device="cpu")
    if params is not None:
        model.load_state_dict(vit_state_dict_from_jax(params, 1, 1),
                              strict=True)
    return model


def _records(out_dir, key):
    with open(os.path.join(str(out_dir), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r[key] for r in rows if r.get("_event") == "log" and key in r]


def _predictions(out_dir, epoch):
    with open(os.path.join(str(out_dir), "validation_predictions",
                           f"{epoch}_validation_predictions.json")) as f:
        return json.load(f)


def _log(out_dir):
    logs = [f for f in os.listdir(str(out_dir))
            if f.startswith("training_log_")]
    assert len(logs) == 1
    with open(os.path.join(str(out_dir), logs[0])) as f:
        return f.read()


def _token_lengths(trainer):
    return [(c.question_max_len, c.decoder_max_len) for c in
            (trainer.train_dataloader.loader.collate_fn,
             trainer.test_dataloader.loader.collate_fn)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vit_trainer")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=16,
                                     num_test=6, image_size=64)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    jmodel = JaxModel(answer_spaces=len(answers),
                      t5_config=JaxT5Config(**T5_KW),
                      vit_config=JaxViTConfig(**VIT_KW), fusing_dropout=0.0)
    rng = np.random.default_rng(0)
    batch = dict(question_input_ids=np.ones((2, 16), np.int32),
                 question_attention_masks=np.ones((2, 16), np.int32),
                 decoder_question_input_ids=np.ones((2, 20), np.int32),
                 decoder_question_attention_masks=np.ones((2, 20), np.int32),
                 pixel_values=np.zeros((2, 224, 224, 3), np.uint8))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), **batch)["params"])
    vm = dict(params["vision_model"])
    for k in ("cls_token", "position_embeddings"):
        vm[k] = rng.normal(0.0, 0.5, vm[k].shape).astype(np.float32)
    params = {**params, "vision_model": vm}

    out, trainers = {}, {}
    for name in ("jax", "port"):
        out_dir = tmp / name
        cfg_path = _write(tmp, _raw_config(root, kw, out_dir))
        if name == "jax":
            trainer = JaxTrainer(jmodel, JaxConfig.from_json(cfg_path),
                                 answers,
                                 params=jax.tree_util.tree_map(np.array,
                                                               params))
        else:
            trainer = VQATrainer(_port_model(len(answers), params),
                                 Config.from_json(cfg_path), answers)
        assert trainer._feature_cache is not None, name
        trainer.train()
        out[name], trainers[name] = out_dir, trainer
    return dict(out=out, trainers=trainers, root=root, kw=kw,
                answers=answers, tmp=tmp)


def test_vit_losses_and_wups_match_jax(runs):
    jax_dir, port_dir = runs["out"]["jax"], runs["out"]["port"]
    for key in ("train_avg_loss", "valid_avg_loss"):
        got, want = _records(port_dir, key), _records(jax_dir, key)
        assert len(got) == len(want) == 2, key
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4,
                                   err_msg=key)
    for key in ("train_avg_wups", "valid_avg_wups"):
        assert _records(port_dir, key) == pytest.approx(
            _records(jax_dir, key), abs=1e-9), key


def test_vit_validation_predictions_match_jax(runs):
    for epoch in (0, 1):
        got = _predictions(runs["out"]["port"], epoch)
        want = _predictions(runs["out"]["jax"], epoch)
        assert len(got) == len(want) == 6          # padding rows dropped
        for g, w in zip(got, want):
            assert {k: g[k] for k in ("question_text", "prediction",
                                      "target")} == \
                {k: w[k] for k in ("question_text", "prediction", "target")}
            assert g["wups_score"] == pytest.approx(w["wups_score"],
                                                    abs=1e-9)


def test_vit_cache_and_token_lengths_match_jax(runs):
    port, jx = runs["trainers"]["port"], runs["trainers"]["jax"]
    assert _token_lengths(port) == _token_lengths(jx)
    q_len, d_len = _token_lengths(port)[0]
    assert q_len < 16 and d_len < 20
    assert port._feature_cache.path_to_slot == jx._feature_cache.path_to_slot
    np.testing.assert_allclose(port._feature_cache.features.numpy(),
                               np.asarray(jx._feature_cache.features),
                               rtol=1e-5, atol=1e-5)
    log = _log(runs["out"]["port"])
    for line in ("Frozen-feature cache: 6 images, ",
                 f"Adaptive token lengths: question {q_len} (cap 16), "
                 f"decoder {d_len} (cap 20)",
                 "Start Training: Max Epoch 2", "Average WUPS Score",
                 "Saving new best-model with F-Score"):
        assert line in log, line


def test_vit_best_model_loads_strictly_and_resumes(runs):
    tmp = runs["tmp"]
    src = os.path.join(str(runs["out"]["port"]), "model_checkpoints")
    saved = torch.load(os.path.join(src, "best-model.pt"), weights_only=True)
    for key in TIED_KEYS:
        assert torch.equal(saved[f"lang_model.{key}.weight"],
                           saved["lang_model.shared.weight"]), key
    fresh = _port_model(len(runs["answers"]))
    fresh.load_state_dict(saved, strict=True)
    assert fresh.lang_model.lm_head.weight is fresh.lang_model.shared.weight

    out_dir = tmp / "resume"
    os.makedirs(out_dir / "model_checkpoints")
    for name in ("best-model.pt", "model_ckpt_info.json",
                 "model-metrics.json"):
        with open(os.path.join(src, name), "rb") as a, \
                open(out_dir / "model_checkpoints" / name, "wb") as b:
            b.write(a.read())
    raw = _raw_config(runs["root"], runs["kw"], out_dir, epochs=1,
                      load_from_checkpoint=True)
    trainer = VQATrainer(_port_model(len(runs["answers"])),
                         Config.from_json(_write(tmp, raw, "resume.json")),
                         runs["answers"])
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved[key]), key
    log = _log(out_dir)
    assert "Loaded from Best Model: best-model" in log
    # the cache is built after the resume, from the resumed tower
    assert log.index("Loaded from Best Model") < log.index(
        "Frozen-feature cache: 6 images")
    trainer.train()
    assert len(_predictions(out_dir, 0)) == 6


def test_vit_entry_point_trains_on_the_cpu(runs, tmp_path, monkeypatch):
    built = []

    def small_model(model_cfg, num_answers, device=None, generator=None):
        built.append(model_cfg.vision_model_name)
        return _port_model(num_answers), "vit"

    monkeypatch.setattr(trainer_module, "build_model", small_model)
    raw = _raw_config(runs["root"], runs["kw"], tmp_path / "out", epochs=1)
    raw["model_kwargs"]["vision_model_name"] = "resnet18"
    raw["dataset_kwargs"]["train_batch_size"] = 8
    raw["dataset_kwargs"]["test_batch_size"] = 6
    path = _write(tmp_path, raw)
    vit_entry.main(["--config", path, "--set", "trainer_kwargs.device=cpu"])
    assert built == [VIT_NAME]
    log = _log(tmp_path / "out")
    assert "Start Training: Max Epoch 1" in log
    assert "Frozen-feature cache: 6 images" in log
    assert os.path.exists(tmp_path / "out" / "model_checkpoints" /
                           "best-model.pt")
    assert len(_predictions(tmp_path / "out", 0)) == 6

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit_entry.main(["--config", path, "--set",
                        "trainer_kwargs.device=tpu"])
    assert len(built) == 1
