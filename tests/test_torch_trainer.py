"""The port's ``VQATrainer`` and its CLI against the JAX package's trainer.

A 2-epoch run on synthetic DAQUAR (16 train questions, 6 test questions so
that the last eval batch is padded) with the JAX package's tiny trainer
model (``tests/test_trainer.py``: resnet18, T5 d_model 32 with one layer,
one SGA block of hidden 32), dropout 0, the cv2 image path on both sides,
from the same initial params. Per-epoch train and validation losses agree
within 3e-4 (the train-step tolerance of ``test_torch_train_step.py``), the
validation predictions and WUPS are the same, ``best-model.pt`` loads
strictly and resumes, and the log has the reference's lines.

``python -m t5_resnet_vqa_torch.train`` runs one tiny epoch on the CPU when
``--set trainer_kwargs.device=cpu`` names it, and raises without a card
otherwise.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxModel
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.train import VQATrainer as JaxTrainer
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import load_answer_spaces
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train import VQATrainer
from t5_resnet_vqa_torch.utils import state_dict_from_jax

from test_torch_train_step import _random_params

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 32
T5_KW = dict(vocab_size=32128, d_model=HIDDEN, d_kv=8, d_ff=64,
             num_layers=1, num_decoder_layers=1, num_heads=4,
             dropout_rate=0.0)
SGA_KW = dict(hidden_size=HIDDEN, num_heads=4, ff_size=HIDDEN,
              dropout_rate=0.0)


def _raw_config(root, kw, out_dir, **trainer):
    return {
        "model_kwargs": {"vision_model_name": "resnet18"},
        "dataset_kwargs": dict(kw, root_data_dir=root, train_batch_size=4,
                               test_batch_size=4, image_size=64,
                               use_native_preprocessor=False),
        "trainer_kwargs": dict(dict(epochs=2, output_dir=str(out_dir),
                                    seed=0, device="cpu",
                                    cache_frozen_features=False,
                                    load_from_checkpoint=False), **trainer),
        "optimizer_kwargs": {"type": "AdamW", "lm_encoder_lr": 1e-3,
                             "classifier_lr": 5e-3, "fusion_lr": 1e-3,
                             "kwargs": {"weight_decay": 0.1,
                                        "amsgrad": True}},
        "callbacks_kwargs": {"kwargs": {"threshold": -1.0, "patience": 3}},
    }


def _write(tmp, raw):
    path = os.path.join(str(tmp), "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _port_model(num_answers, params=None):
    model = ResnetVQAModel(num_answers, vision_model_name="resnet18",
                           t5_config=T5Config(**T5_KW),
                           num_attention_blocks=1,
                           sga_config=AttentionConfig(**SGA_KW),
                           device="cpu")
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params, "resnet18", 1, 1),
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


def _ckpt_json(out_dir, name):
    with open(os.path.join(str(out_dir), "model_checkpoints", name)) as f:
        return json.load(f)


def _log(out_dir):
    logs = [f for f in os.listdir(str(out_dir))
            if f.startswith("training_log_")]
    assert len(logs) == 1
    with open(os.path.join(str(out_dir), logs[0])) as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=16,
                                     num_test=6, image_size=64)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    jmodel = JaxModel(answer_spaces=len(answers), vision_model_name="resnet18",
                      t5_config=JaxT5Config(**T5_KW),
                      sga_config=JaxAttentionConfig(**SGA_KW),
                      num_attention_blocks=1)
    rng = np.random.default_rng(0)
    batch = dict(question_input_ids=np.ones((2, 16), np.int32),
                 question_attention_masks=np.ones((2, 16), np.int32),
                 image_tensors=np.zeros((2, 64, 64, 3), np.uint8))
    params = _random_params(jmodel, batch, rng)

    out = {}
    for name in ("jax", "port"):
        out_dir = tmp / name
        cfg_path = _write(tmp, _raw_config(root, kw, out_dir))
        if name == "jax":
            cfg = JaxConfig.from_json(cfg_path)
            trainer = JaxTrainer(jmodel, cfg, answers,
                                 params=jax.tree_util.tree_map(np.array,
                                                               params))
        else:
            cfg = Config.from_json(cfg_path)
            trainer = VQATrainer(_port_model(len(answers), params), cfg,
                                 answers)
        trainer.train()
        out[name] = out_dir
    return dict(out=out, root=root, kw=kw, answers=answers, tmp=tmp)


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


def test_validation_predictions_match_jax(runs):
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
    ours, theirs = (_ckpt_json(runs["out"][n], "model_ckpt_info.json")
                    for n in ("port", "jax"))
    assert set(ours) == set(theirs)
    assert ours.pop("best_score") == pytest.approx(theirs.pop("best_score"),
                                                   abs=1e-9)
    assert ours == theirs
    ours, theirs = (_ckpt_json(runs["out"][n], "model-metrics.json")
                    for n in ("port", "jax"))
    assert ours["best-score"] == pytest.approx(theirs["best-score"], abs=1e-9)


def test_log_lines_and_best_model_reload(runs):
    port_dir = runs["out"]["port"]
    log = _log(port_dir)
    for line in ("Start Training: Max Epoch 2", "Average WUPS Score",
                 "Saving new best-model with F-Score",
                 "Epoch #1: Average Validation Loss",
                 "WUPS metric mode: mini-wordnet",
                 "Not implemented by the port, no effect on the numbers"):
        assert line in log, line
    path = os.path.join(str(port_dir), "model_checkpoints", "best-model.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)
    fresh = _port_model(len(runs["answers"]))
    fresh.load_state_dict(state, strict=True)
    assert all(v.dtype != torch.bfloat16 for v in state.values())


def test_resume_loads_best_model_params(runs):
    tmp = runs["tmp"]
    out_dir = tmp / "resume"
    os.makedirs(out_dir / "model_checkpoints")
    src = os.path.join(str(runs["out"]["port"]), "model_checkpoints")
    for name in ("best-model.pt", "model_ckpt_info.json",
                 "model-metrics.json"):
        with open(os.path.join(src, name), "rb") as a, \
                open(out_dir / "model_checkpoints" / name, "wb") as b:
            b.write(a.read())
    raw = _raw_config(runs["root"], runs["kw"], out_dir, epochs=1,
                      load_from_checkpoint=True)
    cfg = Config.from_json(_write(tmp, raw))
    trainer = VQATrainer(_port_model(len(runs["answers"])), cfg,
                         runs["answers"])
    saved = torch.load(os.path.join(src, "best-model.pt"),
                       weights_only=True)
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved[key]), key
    assert trainer.callbacks.best_score == \
        _ckpt_json(runs["out"]["port"], "model-metrics.json")["best-score"]
    assert "Loaded from Best Model: best-model" in _log(out_dir)


def test_unported_knobs_raise(runs, tmp_path):
    # the trainer refuses no knob any more: reduced_decode and num_workers
    # reach its collates (tests/test_torch_reduced_decode.py) and OK-VQA its
    # datasets (tests/test_torch_okvqa.py); the one refusal left is a mesh,
    # in the entry point
    raw = _raw_config(runs["root"], runs["kw"], tmp_path)
    raw["dataset_kwargs"].update(reduced_decode=2, num_workers=2)
    path = _write(tmp_path, raw)
    trainer = VQATrainer(_port_model(len(runs["answers"])),
                         Config.from_json(path), runs["answers"])
    for loader in (trainer.train_dataloader, trainer.test_dataloader):
        assert (loader.collate_fn.reduced_decode,
                loader.collate_fn.num_workers) == (2, 2)
    ignored = next(line for line in _log(tmp_path).splitlines()
                   if "Not implemented by the port" in line)
    assert "num_workers" not in ignored
    from t5_resnet_vqa_torch.train.__main__ import parse_args
    for mesh in (["--data-parallel", "2"], ["--model-parallel", "2"]):
        with pytest.raises(NotImplementedError, match="item 11"):
            parse_args(["--config", path, *mesh])


def test_trainer_raises_without_a_card(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = _raw_config(runs["root"], runs["kw"], tmp_path, device="tpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQATrainer(_port_model(len(runs["answers"])),
                   Config.from_json(_write(tmp_path, raw)), runs["answers"])


def _cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "t5_resnet_vqa_torch.train", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_cli_trains_one_epoch_on_the_cpu(runs, tmp_path):
    raw = _raw_config(runs["root"], runs["kw"], tmp_path / "out", epochs=1)
    raw["dataset_kwargs"]["train_batch_size"] = 8
    raw["dataset_kwargs"]["test_batch_size"] = 6
    path = _write(tmp_path, raw)
    done = _cli(["--config", path, "--set", "trainer_kwargs.device=cpu",
                 "--set", "model_kwargs.vision_model_name=resnet18"])
    assert done.returncode == 0, done.stderr[-3000:]
    assert "Start Training: Max Epoch 1" in done.stdout
    assert "Average WUPS Score" in done.stdout
    assert os.path.exists(tmp_path / "out" / "model_checkpoints" /
                          "best-model.pt")
    assert len(_predictions(tmp_path / "out", 0)) == 6

    refused = _cli(["--config", path, "--set", "trainer_kwargs.device=tpu"])
    assert refused.returncode != 0
    assert "no CUDA device" in refused.stderr
