"""The Faster-RCNN and cross-attention families on a card: the attention
kernel at the RoBERTa shape (S=213) against its plain version, forward and
backward, and each family's model with the kernels on against off.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it on its own, past
the JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_family_gpu.py

* Attention at B=4, H=12, S=213 (197 image + 16 question tokens), D=64 on
  the head views of [B, S, H*D] projections: output and the three input
  gradients within 1e-5 (fp32) / 1e-2 (bf16) of max|plain|, the smoke's
  ``ATT_TOL``. 213 is not a multiple of the kernel's 16-row tiles, so
  every tile row takes the padded-key path.
* A ``RobertaLayer`` of roberta-base width (768, 12 heads) at S=213, B=2:
  one launch per forward, within 1e-4 (fp32) / 3e-2 (bf16) of the plain
  layer (``tests/test_torch_vit_gpu.py`` gives the reasons).
* ``FasterRcnnVQAModel``: the full ResNet-50 body and FPN at 256^2 (the
  ``pool`` level 4x4, 16 vision tokens), T5 cut to 2 layers, 3 SGA blocks
  of the production geometry (H=8, D=96), B=2: 6 attention and 7
  bottleneck launches per forward; ``CrossAttentionVitVQAModel``: ViT-base
  x RoBERTa-base widths cut to 2 layers at 224^2, B=2: 4 attention
  launches per forward. Log-probs within the smoke's ``LOGPROB_TOL``
  (fp32 1e-3, bf16 5e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.models import (
    CrossAttentionVitVQAModel,
    FasterRcnnVQAModel,
    RobertaConfig,
    RobertaLayer,
    T5Config,
    ViTConfig,
)
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K

pytestmark = pytest.mark.gpu

ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LAYER_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LOGPROB_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
DTYPES = [torch.float32, torch.bfloat16]


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_at_s213_forward_and_backward(cuda, dtype):
    B, H, S, D = 4, 12, 213, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    projections = [torch.randn(B, S, H * D, device=cuda, generator=g)
                   .to(dtype) for _ in range(3)]
    grad_out = torch.randn(B, H, S, D, device=cuda, generator=g).to(dtype)
    results = {}
    for name, fn in (("kernel", A.fused_attention),
                     ("plain", A.attention_reference)):
        leaves = [p.clone().requires_grad_() for p in projections]
        count = A.launches
        out = fn(*(x.reshape(B, S, H, D).transpose(1, 2) for x in leaves))
        assert A.launches - count == (name == "kernel")
        results[name] = (out, *torch.autograd.grad(out, leaves, grad_out))
    for got, want in zip(results["kernel"], results["plain"]):
        assert _rel_err(got, want) <= ATT_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_roberta_layer_kernel_matches_plain_at_s213(cuda, dtype):
    cfg = dataclasses.replace(RobertaConfig.roberta_base(), dropout_rate=0.0)
    plain = RobertaLayer(cfg, use_kernel=False)
    init_weights(plain, torch.Generator().manual_seed(1))
    kernel = RobertaLayer(cfg, use_kernel=True)
    kernel.load_state_dict(plain.state_dict())
    plain, kernel = (m.to(cuda, dtype).eval() for m in (plain, kernel))
    x = torch.randn(2, 213, cfg.hidden_size, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2)
                    ).to(dtype)
    with torch.inference_mode():
        count = A.launches
        got = kernel(x)
        assert A.launches - count == 1
        want = plain(x)
    assert _rel_err(got, want) <= LAYER_TOL[dtype]


def _frcnn(flag, dtype, cuda):
    return FasterRcnnVQAModel(
        7, t5_config=T5Config(num_layers=2, dropout_rate=0.0),
        sga_config=AttentionConfig(dropout_rate=0.0), use_kernels=flag,
        dtype=dtype, device=cuda,
        generator=torch.Generator().manual_seed(3)).eval()


def _cross(flag, dtype, cuda):
    return CrossAttentionVitVQAModel(
        7, vit_config=ViTConfig(num_layers=2),
        roberta_config=RobertaConfig(num_layers=2, dropout_rate=0.0),
        use_kernels=flag, dtype=dtype, device=cuda,
        generator=torch.Generator().manual_seed(3)).eval()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", ["faster_rcnn", "cross"])
def test_model_kernels_on_against_off(cuda, family, dtype):
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(2, 1000, (2, 16))).to(cuda)
    size = 256 if family == "faster_rcnn" else 224
    images = torch.from_numpy(rng.integers(0, 256, (2, size, size, 3),
                                           dtype=np.uint8)).to(cuda)
    build = _frcnn if family == "faster_rcnn" else _cross
    log_probs = {}
    for flag in (True, False):
        model = build(flag, dtype, cuda)
        if family == "faster_rcnn":
            batch = dict(question_input_ids=ids,
                         question_attention_masks=torch.ones_like(ids),
                         image_tensors=images)
            want = (6, 7) if flag else (0, 0)
        else:
            batch = dict(question_input_ids=ids, pixel_values=images)
            want = (4, 0) if flag else (0, 0)
        counts = (A.launches, K.launches)
        with torch.inference_mode():
            log_probs[flag] = model(**batch)[0]
        assert (A.launches - counts[0], K.launches - counts[1]) == want
        del model
    assert bool(torch.isfinite(log_probs[True]).all())
    diff = float((log_probs[True] - log_probs[False]).abs().max())
    assert diff <= LOGPROB_TOL[dtype], diff
