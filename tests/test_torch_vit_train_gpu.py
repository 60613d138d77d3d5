"""The ViT family's training path on a card: the attention kernel's backward
at the ViT shape, a fine-tuned train step with the kernels on against off,
and the frozen-feature cache's build through the kernel.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it past the
JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_vit_train_gpu.py

* The kernel's backward (the VJP of the plain version) at the training
  shape, B=64, H=12, S=197, D=64, on the head views of [B, S, H*D]
  projections as the ViT hands them over, against ``torch.autograd.grad``
  of the plain version: max-abs error over max|plain| 1e-5 in fp32, 1e-2 in
  bf16 (the forward's tolerances, ``tests/test_torch_kernels_gpu.py``).
* One fp32 train step of a fine-tuned tower (ViT-base geometry cut to 2
  layers, a small T5), kernels on against off, no TF32: one attention
  launch per layer, every tower parameter trains, the loss within 1e-4
  relative and the parameters within rtol 5e-3 / atol 5e-4 (the CPU parity
  tolerance of ``tests/test_torch_train_step.py``).
* The cache build: 10 images in chunks of 4 launch the kernel once per
  layer per chunk (3 chunks, the tail padded), and a forward on the
  gathered features matches the image-fed forward of all 10 images (fp32,
  rtol/atol 1e-4: cuBLAS picks its kernels by the number of rows, so
  chunks of 4 and a batch of 10 sum in other orders).
"""

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.core.config import LRSchedulerConfig, OptimizerConfig
from t5_resnet_vqa_torch.data import Annotation, Question, Sample
from t5_resnet_vqa_torch.models import T5Config, ViTConfig, VitVQAModel
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.train import (
    build_feature_cache,
    build_optimizer,
    make_train_step,
)
from t5_resnet_vqa_torch.train.optimizer import FROZEN_LABEL, label_params

pytestmark = pytest.mark.gpu

ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LAYERS = 2
ANSWERS = 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_backward_at_s197_matches_plain_vjp(cuda, dtype):
    B, H, S, D = 64, 12, 197, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    projections = [torch.randn(B, S, H * D, device=cuda,
                               generator=g).to(dtype) for _ in range(3)]
    grad_out = torch.randn(B, H, S, D, device=cuda, generator=g).to(dtype)

    def run(fn):
        leaves = [p.clone().requires_grad_() for p in projections]
        out = fn(*(x.reshape(B, S, H, D).transpose(1, 2) for x in leaves))
        return out, torch.autograd.grad(out, leaves, grad_out)

    before = A.launches
    out, got = run(A.fused_attention)
    assert A.launches == before + 1
    ref, want = run(A.attention_reference)
    assert _rel_err(out, ref) <= ATT_TOL[dtype]
    for gk, wk in zip(got, want):
        assert gk.dtype == dtype and gk.shape == wk.shape
        assert _rel_err(gk, wk) <= ATT_TOL[dtype]


def _model(cuda, use_kernels, fine_tune_vision=False):
    return VitVQAModel(
        ANSWERS, t5_config=T5Config(vocab_size=64, d_model=64, d_kv=16,
                                    d_ff=128, num_layers=1,
                                    num_decoder_layers=1, num_heads=4,
                                    dropout_rate=0.0),
        vit_config=ViTConfig(num_layers=LAYERS),
        fine_tune_vision=fine_tune_vision, use_kernels=use_kernels,
        fusing_dropout=0.0, device=cuda,
        generator=torch.Generator().manual_seed(3)).train()


def _batch(cuda, g, b=4):
    return {
        "question_input_ids": torch.randint(2, 64, (b, 16), device=cuda,
                                            generator=g),
        "question_attention_masks": torch.ones(b, 16, dtype=torch.int64,
                                               device=cuda),
        "decoder_question_input_ids": torch.randint(2, 64, (b, 20),
                                                    device=cuda, generator=g),
        "decoder_question_attention_masks": torch.ones(
            b, 20, dtype=torch.int64, device=cuda),
        "pixel_values": torch.randint(0, 256, (b, 224, 224, 3), device=cuda,
                                      generator=g).to(torch.uint8),
        "annotation_ids": torch.randint(0, ANSWERS, (b,), device=cuda,
                                        generator=g),
    }


def test_fine_tuned_vit_step_with_kernels_matches_without_fp32(cuda):
    batch = _batch(cuda, torch.Generator(device=cuda).manual_seed(4))
    opt_cfg = OptimizerConfig(vision_lr=1e-4, lm_encoder_lr=1e-3,
                              lm_decoder_lr=3e-4, fusion_lr=1e-3,
                              classifier_lr=5e-3,
                              kwargs={"weight_decay": 0.1, "amsgrad": True})
    runs = {}
    for use_kernels in (True, False):
        model = _model(cuda, use_kernels, fine_tune_vision=True)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        optimizer, scheduler, _, trainable = build_optimizer(
            model, opt_cfg, LRSchedulerConfig(num_warmup_steps=0), 2,
            frozen_modules=model.frozen_modules())
        step = make_train_step(model, optimizer, scheduler, trainable, 1.0)
        a0 = A.launches
        loss = float(step(batch)[0])
        runs[use_kernels] = (model, loss, A.launches - a0, before)

    (on, on_loss, on_count, before), (off, off_loss, off_count, _) = \
        runs[True], runs[False]
    assert (on_count, off_count) == (LAYERS, 0)
    assert abs(on_loss - off_loss) <= 1e-4 * abs(off_loss)
    labels = label_params(on, frozen_modules=on.frozen_modules())
    assert {labels[n] for n in labels if n.startswith("vision_model.")} == \
        {"vision"}
    off_state = off.state_dict()
    for name, p in on.state_dict().items():
        if labels.get(name, FROZEN_LABEL) == FROZEN_LABEL:
            continue
        if name.startswith("vision_model."):
            assert not torch.equal(p, before[name]), name
        torch.testing.assert_close(p, off_state[name], rtol=5e-3,
                                   atol=5e-4, msg=name)


def test_cache_build_launches_the_kernel_per_layer_and_chunk(cuda):
    model = _model(cuda, use_kernels=True).eval()
    rng = np.random.default_rng(5)
    paths = [f"img{i}.png" for i in range(10)]
    pixels = {p: rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
              for p in paths}
    samples = [Sample(Question("what is it", f"q{i}", p),
                      Annotation(f"a{i}", p, ["x"]), p)
               for i, p in enumerate(paths)]
    a0 = A.launches
    (cache, (rows,), _), why = build_feature_cache(
        model, [samples], lambda chunk: np.stack([pixels[p] for p in chunk]),
        batch_size=4)
    assert why is None
    assert A.launches - a0 == 3 * LAYERS
    assert cache.features.shape == (10, 768)
    assert cache.features.device.type == "cuda"
    np.testing.assert_array_equal(rows, np.arange(10))

    batch = _batch(cuda, torch.Generator(device=cuda).manual_seed(6), b=10)
    batch["pixel_values"] = torch.from_numpy(
        np.stack([pixels[p] for p in paths])).to(cuda)
    text = {k: v for k, v in batch.items() if k != "pixel_values"}
    with torch.no_grad():
        want, _ = model(**batch)
        got, _ = model(**text, vision_features=cache.gather(rows))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
