"""The training path's use of the hand-written kernels, on a card.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it past the
JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_train_gpu.py

* The attention kernel's backward (the VJP of the plain version) against
  ``torch.autograd.grad`` of the plain version, on the head views of
  [B, S, H*D] projections, as the SGA blocks hand them over. Tolerances
  are the forward's (``tests/test_torch_kernels_gpu.py``): max-abs error
  relative to max|plain| 1e-5 in fp32, 1e-2 in bf16.
* The bottleneck wrapper has no backward and refuses an input that
  requires a gradient.
* Three fp32 train steps at a small width, kernels on against off, same
  weights and batches, no TF32: losses within 1e-4 relative, trainable
  params within rtol 5e-3 / atol 5e-4 (the CPU parity tolerance of
  ``tests/test_torch_train_step.py``: AdamW divides each update by the
  root of its second moment, so a sum taken in another order moves an
  element with a tiny gradient by up to its LR).
"""

import pytest
import torch

from t5_resnet_vqa_torch.core.config import LRSchedulerConfig, OptimizerConfig
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.models.resnet import Bottleneck
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.train import build_optimizer, make_train_step
from t5_resnet_vqa_torch.train.optimizer import FROZEN_LABEL, label_params

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, "fp32"), (torch.bfloat16, "bf16")]
ATT_TOL = {"fp32": 1e-5, "bf16": 1e-2}


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


@pytest.mark.parametrize("dtype,name", DTYPES)
@pytest.mark.parametrize("B,H,Sq,Sk,D", [
    (4, 8, 16, 16, 96),      # SGA mhatt1
    (4, 8, 16, 64, 96),      # SGA mhatt2 of block 0
    (2, 12, 197, 197, 64),   # ViT self-attention
])
def test_attention_backward_matches_plain_vjp(cuda, dtype, name, B, H, Sq,
                                              Sk, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    projections = [torch.randn(B, s, H * D, device=cuda,
                               generator=g).to(dtype)
                   for s in (Sq, Sk, Sk)]
    grad_out = torch.randn(B, H, Sq, D, device=cuda, generator=g).to(dtype)

    def heads(x):
        return x.reshape(B, -1, H, D).transpose(1, 2)

    def run(fn):
        leaves = [p.clone().requires_grad_() for p in projections]
        out = fn(*map(heads, leaves))
        return out, torch.autograd.grad(out, leaves, grad_out)

    before = A.launches
    out, got = run(A.fused_attention)
    assert A.launches == before + 1
    ref, want = run(A.attention_reference)
    assert _rel_err(out, ref) <= ATT_TOL[name]
    for gk, wk in zip(got, want):
        assert gk.dtype == dtype and gk.shape == wk.shape
        assert _rel_err(gk, wk) <= ATT_TOL[name]


def test_bottleneck_wrapper_refuses_an_input_that_needs_a_gradient(cuda):
    block = Bottleneck(64, 64, 1, True)
    init_weights(block, torch.Generator().manual_seed(1))
    block = block.to(cuda, torch.bfloat16)
    x = torch.randn(2, 16, 16, 64, device=cuda).to(torch.bfloat16)
    before = K.launches
    with pytest.raises(RuntimeError, match="no backward"):
        K.fused_bottleneck_packed(x.requires_grad_(), block.fused)
    assert K.launches == before
    with torch.no_grad():
        out = K.fused_bottleneck_packed(x, block.fused)
    assert K.launches == before + 1
    assert out.shape == (2, 16, 16, 256)


def _model(cuda, use_kernels):
    return ResnetVQAModel(
        7, vision_model_name="resnet50",
        t5_config=T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                           num_layers=2, num_heads=4, dropout_rate=0.0),
        num_attention_blocks=2,
        sga_config=AttentionConfig(hidden_size=32, num_heads=4, ff_size=64,
                                   dropout_rate=0.0),
        use_kernels=use_kernels, device=cuda,
        generator=torch.Generator().manual_seed(3)).train()


def test_train_steps_with_kernels_match_without_fp32(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    batches = [{
        "question_input_ids": torch.randint(0, 64, (4, 16), device=cuda,
                                            generator=g),
        "question_attention_masks": torch.ones(4, 16, dtype=torch.int64,
                                               device=cuda),
        "image_tensors": torch.randint(0, 256, (4, 64, 64, 3), device=cuda,
                                       generator=g).to(torch.uint8),
        "annotation_ids": torch.randint(0, 7, (4,), device=cuda,
                                        generator=g),
    } for _ in range(3)]
    opt_cfg = OptimizerConfig(lm_encoder_lr=1e-3, fusion_lr=1e-3,
                              classifier_lr=5e-3,
                              kwargs={"weight_decay": 0.1, "amsgrad": True})
    runs = {}
    for use_kernels in (True, False):
        model = _model(cuda, use_kernels)
        optimizer, scheduler, _, trainable = build_optimizer(
            model, opt_cfg, LRSchedulerConfig(), 3,
            frozen_modules=model.frozen_modules())
        step = make_train_step(model, optimizer, scheduler, trainable, 1.0)
        losses, counts = [], []
        for batch in batches:
            a0, k0 = A.launches, K.launches
            losses.append(float(step(batch)[0]))
            counts.append((A.launches - a0, K.launches - k0))
        runs[use_kernels] = (model, losses, counts)

    (on, on_losses, on_counts), (off, off_losses, off_counts) = \
        runs[True], runs[False]
    assert on_counts == [(4, 7)] * 3 and off_counts == [(0, 0)] * 3
    for a, b in zip(on_losses, off_losses):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert on_losses[-1] != on_losses[0]
    labels = label_params(on, frozen_modules=on.frozen_modules())
    off_state = off.state_dict()
    for name, p in on.state_dict().items():
        if labels.get(name, FROZEN_LABEL) == FROZEN_LABEL:
            assert torch.equal(p, off_state[name]), name
        else:
            torch.testing.assert_close(p, off_state[name], rtol=5e-3,
                                       atol=5e-4, msg=name)
