"""The ViT family on a card: the tower at S=197 with the attention kernel
against its plain version, and generation with the kernels on against off.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it on its own, past
the JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_vit_gpu.py

The tower: ViT-base geometry (224^2 images in 16x16 patches, 197 tokens,
hidden 768, 12 heads of 64) cut to 2 layers, B=4, one attention launch per
layer. Hidden states and pooled output as max-abs error over max|plain|:
fp32 1e-4 (the kernel's fp32 sums run in another order), bf16 3e-2 (the
kernel's and the plain version's outputs differ by bf16 roundings, which
the next layer's LayerNorm and MLP carry on). Generation: a small model
(hidden 64, 2 layers per stack) in fp32 through ``generate_batch``, greedy
tokens equal, beam tokens equal and scores within 1e-4.
"""

import warnings

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import T5Config, ViTConfig, ViTModel
from t5_resnet_vqa_torch.models import VitVQAModel
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import attention as A

pytestmark = pytest.mark.gpu

TOWER_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_tower_kernel_matches_plain_at_s197(cuda, dtype):
    cfg = ViTConfig(num_layers=2)
    g = torch.Generator().manual_seed(0)
    plain = ViTModel(cfg, use_kernel=False)
    init_weights(plain, g)
    with torch.no_grad():
        plain.embeddings.cls_token.normal_(0.0, 0.02, generator=g)
        plain.embeddings.position_embeddings.normal_(0.0, 0.02, generator=g)
    kernel = ViTModel(cfg, use_kernel=True)
    kernel.load_state_dict(plain.state_dict(), strict=True)
    plain, kernel = (m.to(cuda, dtype).eval() for m in (plain, kernel))
    x = torch.randn(4, 224, 224, 3, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    before = A.launches
    with torch.inference_mode():
        got_h, got_p = kernel(x)
        assert A.launches == before + cfg.num_layers
        want_h, want_p = plain(x)
        assert A.launches == before + cfg.num_layers
        maps = kernel(x, return_attentions=True)[2]
    assert A.launches == before + cfg.num_layers   # maps: the plain path
    assert got_h.shape == (4, 197, 768) and got_h.dtype == dtype
    assert maps.shape == (2, 4, 12, 197, 197)
    assert _rel_err(got_h, want_h) <= TOWER_TOL[dtype]
    assert _rel_err(got_p, want_p) <= TOWER_TOL[dtype]


def _sessions(cuda):
    answers = [f"answer{i}" for i in range(9)]
    rng = np.random.default_rng(2)
    images = {f"img{i}.png": rng.integers(0, 256, (224, 224, 3),
                                          dtype=np.uint8) for i in range(6)}
    vit = ViTConfig(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)
    t5 = T5Config(d_model=64, d_kv=16, d_ff=128, num_layers=2,
                  num_decoder_layers=2, num_heads=4)
    sessions = {}
    state = None
    for flag in (True, False):
        model = VitVQAModel(len(answers), t5_config=t5, vit_config=vit,
                            use_kernels=flag, device=cuda,
                            generator=torch.Generator().manual_seed(3))
        session = VQAInferenceSession(model, state, answers, "vit",
                                      batch_size=4, device=cuda)
        session.collate.load_images = \
            lambda paths: np.stack([images[p] for p in paths])
        state = session.model.state_dict()
        sessions[flag] = session
    requests = [(f"img{i}.png", f"what is on the shelf number {i}?")
                for i in range(6)]
    return sessions, requests


def test_generate_batch_kernels_on_matches_off(cuda):
    sessions, requests = _sessions(cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the hash tokenizer's warning
        before = A.launches
        greedy = {f: s.generate_batch(requests, num_beams=1)
                  for f, s in sessions.items()}
        # two chunks of 4, each fusing once: 2 layers x 2 forwards
        assert A.launches == before + 4
        beam = {f: s.generate_batch(requests, num_beams=3)
                for f, s in sessions.items()}
    assert [r["token_ids"] for r in greedy[True]] == \
        [r["token_ids"] for r in greedy[False]]
    assert [r["token_ids"] for r in beam[True]] == \
        [r["token_ids"] for r in beam[False]]
    np.testing.assert_allclose([r["score"] for r in beam[True]],
                               [r["score"] for r in beam[False]],
                               rtol=1e-4, atol=1e-4)
    assert any(r["token_ids"] for r in greedy[True])
    on = sessions[True].ask_batch(requests)
    assert [r["answer"] for r in on] == \
        [r["answer"] for r in sessions[False].ask_batch(requests)]
