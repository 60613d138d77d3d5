"""The trainer's checkpoint pair and resume with the model on a card.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it past the
JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_checkpoint_gpu.py

A small CNN-family model (ResNet-18, T5 d_model 64) trains on seeded uint8
images (the card's machine has no image decoder) with bf16 compute, so the
frozen tower is held in bf16, and writes its pair every 2 steps. Then:

* a resumed trainer holds, on the card, the model and optimizer state of
  the first run's end, bit for bit (AMSGrad's ``max_exp_avg_sq`` and the
  step counts too), the bf16 tower exactly (it was saved widened to fp32),
  and the LRs of the schedule at the restored step;
* a background pair save submitted from the card's tensors, with three
  steps launched right after it, writes the state at submission: not the
  later one, which the optimizer wrote in place meanwhile.
"""

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import (
    Annotation,
    DaquarCollateBase,
    Question,
    Sample,
    to_device,
)
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train import VQATrainer
from t5_resnet_vqa_torch.train.callbacks import checkpoint_state_dict
from t5_resnet_vqa_torch.train.trainer import _device_batch

pytestmark = pytest.mark.gpu

ANSWERS = [f"answer{i}" for i in range(12)]
SIZE = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _model():
    return ResnetVQAModel(
        len(ANSWERS), vision_model_name="resnet18",
        t5_config=T5Config(vocab_size=32128, d_model=64, d_kv=16, d_ff=128,
                           num_layers=1, num_heads=4),
        num_attention_blocks=1,
        sga_config=AttentionConfig(hidden_size=64, num_heads=4, ff_size=64),
        device="cuda", generator=torch.Generator().manual_seed(0))


def _samples(name, n, rng):
    return [Sample(Question(f"what is on the table {i}", f"{name}{i}",
                            f"{name}{i % 4}"),
                   Annotation(f"{name}{i}", f"{name}{i % 4}",
                              [ANSWERS[int(rng.integers(len(ANSWERS)))]]),
                   f"{name}{i % 4}.png") for i in range(n)]


def _config(out_dir, resume, epochs):
    cfg = Config()
    cfg.model.vision_model_name = "resnet18"
    cfg.model.compute_dtype = "bfloat16"
    cfg.dataset.train_batch_size = cfg.dataset.test_batch_size = 4
    cfg.dataset.image_size = SIZE
    cfg.trainer.epochs = epochs
    cfg.trainer.device = "cuda"
    cfg.trainer.output_dir = str(out_dir)
    cfg.trainer.checkpoint_every_steps = 2
    cfg.trainer.cache_frozen_features = False
    cfg.trainer.load_from_checkpoint = resume
    cfg.callbacks.threshold = -1.0
    return cfg.validate()


@pytest.fixture
def runs(cuda, tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    images = {}

    def load_images(self, paths):
        for p in paths:
            if p not in images:
                images[p] = rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)
        return np.stack([images[p] for p in paths])

    monkeypatch.setattr(DaquarCollateBase, "load_images", load_images)
    train, test = _samples("train", 12, rng), _samples("test", 4, rng)
    first = VQATrainer(_model(), _config(tmp_path, False, 2), ANSWERS,
                       train, test)
    first.train()
    # a longer run: its schedule is not at its end (LR 0) at step 6
    resumed = VQATrainer(_model(), _config(tmp_path, True, 4), ANSWERS,
                         train, test)
    return first, resumed


def _same(got, want, where):
    if isinstance(want, torch.Tensor):
        assert got.device == want.device, where
        assert got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    else:
        assert got == want, where


def test_resume_restores_the_state_on_the_card(runs):
    first, resumed = runs
    assert (resumed.start_epoch, resumed.global_step) == (2, 6)
    assert resumed.model.vision_model.conv1.weight.dtype == torch.bfloat16
    _same(resumed.model.state_dict(), first.model.state_dict(), "model")
    got, want = (t.optimizer.state_dict()["state"] for t in (resumed, first))
    _same(got, want, "optimizer")
    moments = next(iter(got.values()))
    assert moments["max_exp_avg_sq"].is_cuda and moments["exp_avg"].is_cuda
    for group in resumed.optimizer.param_groups:
        assert group["lr"] == resumed._schedules[group["group"]](6)


def test_background_pair_save_writes_the_submitted_state(runs):
    _, trainer = runs
    batch = _device_batch(to_device(next(iter(trainer.train_dataloader)),
                                    trainer.device))
    trainer.model.train()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    # copies: the step counts live on the CPU, where .cpu() is no copy
    want_model = {k: v.to("cpu", copy=True) for k, v in
                  checkpoint_state_dict(trainer.model).items()}
    want_moments = {i: {k: v.to("cpu", copy=True) for k, v in s.items()}
                    for i, s in
                    trainer.optimizer.state_dict()["state"].items()}
    ckpt = trainer.callbacks.ckpt
    trainer.callbacks.save_epoch_checkpoint(
        trainer.model, 7, trainer.optimizer, trainer.scheduler, 99)
    for _ in range(3):                   # in place, while the save runs
        trainer.train_step(batch)
    ckpt.flush()
    params = ckpt.restore_tree("checkpoint-model")
    state = ckpt.restore_tree("state_dict_checkpoint")
    assert (state["epoch"], state["global_step"]) == (7, 99)
    _same(params, want_model, "model")
    _same(state["optimizer"]["state"], want_moments, "optimizer")
    live = checkpoint_state_dict(trainer.model)
    assert any(not torch.equal(live[k].cpu(), v)
               for k, v in want_model.items()), "the steps changed nothing"
