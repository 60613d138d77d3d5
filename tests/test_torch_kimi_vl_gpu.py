"""Kimi-VL's library paths that run only on a card (``ops/moe.py``,
``ops/mla.py``): the grouped GEMMs of ``torch._grouped_mm`` on bf16 CUDA
tensors against the plain loop, empty experts included; the decode core's
scores with fp32 output against the same math in fp32; and the tiny model's
cached generation in bf16 on the card against the plain reference.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it on its own::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kimi_vl_gpu.py
"""

from __future__ import annotations

import pytest
import torch

import kimi_vl_reference as ref
from t5_resnet_vqa_torch.models import (
    KimiVLConfig,
    build_kimi_vl,
    cached_greedy_generate,
)
from t5_resnet_vqa_torch.ops import mla, moe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._grouped_mm and the "
                    "fp32-output bmm run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_grouped_mm_against_the_loop(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(37, 256, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(8, 384, 256, generator=g, device=cuda).to(torch.bfloat16)
    # groups of 3, 0, 7, 1, 9, 0, 10 and 7 rows
    offs = torch.tensor([3, 3, 10, 11, 20, 20, 30, 37], dtype=torch.int32,
                        device=cuda)
    got = moe.grouped_mm(a, w, offs).float()
    want = moe.grouped_mm(a.float(), w.float(), offs)
    # bf16 output: half a unit in the last place of the largest value
    assert (got - want).abs().max() <= want.abs().max() * 2 ** -8


@pytest.mark.gpu
def test_decode_scores_keep_fp32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(4, 16, 576, generator=g, device=cuda)
    cache = torch.randn(4, 100, 576, generator=g, device=cuda)
    qb, cb = q.to(torch.bfloat16), cache.to(torch.bfloat16)
    got = mla._scores(qb, cb)
    assert got.dtype == torch.float32
    want = qb.float() @ cb.float().transpose(1, 2)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_cached_generation_in_bf16_on_the_card(cuda):
    from test_torch_kimi_vl import CFG, PAD, TEXT, VISION, _images, _prompts

    weights = ref.draw(CFG, 7)
    model = build_kimi_vl(KimiVLConfig.from_dict(TEXT, VISION, PAD),
                          dtype=torch.bfloat16)
    model.load_state_dict({k: v.to(cuda, torch.bfloat16)
                           for k, v in weights.items()},
                          strict=True, assign=True)
    rows, ids, lengths = _prompts()
    images = _images(2)
    with torch.inference_mode():
        tokens, top, values = cached_greedy_generate(
            model.eval(), ids.to(cuda), lengths.to(cuda), images.to(cuda),
            max_answer_length=4)
    for i, r in enumerate(rows):
        want = ref.logits(weights, CFG, r + tokens[i, :-1].tolist(),
                          images[i]).log_softmax(-1)[len(r) - 1:]
        got = values[i].float().cpu()
        # bf16 weights and activations at a tiny width: about 1e-2
        assert (got - want.gather(1, top[i].cpu())).abs().max() < 5e-2
