"""The port's hand-written CUDA kernels against their plain versions, on
a card.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it on its own, past
the JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tolerances, as max-abs error relative to max|plain|: attention fp32 1e-5,
bf16 1e-2 (the probabilities are rounded to bf16 before P.V in both, but
the sums run in another order); bottleneck fp32 1e-4 (K up to 1152 summed
in another order), bf16 2e-2 (tests/test_fused_bottleneck.py's tolerance:
t1 and t2 are rounded to bf16 between the products, and an ulp apart
there moves the next product). Whole model, kernels on against off, in
fp32: log-probs within 1e-3.
"""

import pytest
import torch

from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.models.resnet import Bottleneck
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, "fp32"), (torch.bfloat16, "bf16")]
ATT_TOL = {"fp32": 1e-5, "bf16": 1e-2}
BLOCK_TOL = {"fp32": 1e-4, "bf16": 2e-2}


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


@pytest.mark.parametrize("dtype,name", DTYPES)
@pytest.mark.parametrize("B,H,Sq,Sk,D", [
    (4, 8, 16, 16, 96),      # SGA mhatt1
    (4, 8, 16, 64, 96),      # SGA mhatt2 of block 0 (8x8 vision tokens)
    (2, 12, 197, 197, 64),   # ViT self-attention
    (3, 4, 20, 25, 24),      # nothing aligned
])
def test_attention_kernel_matches_plain(cuda, dtype, name, B, H, Sq, Sk, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, s, D, device=cuda, generator=g).to(dtype)
               for s in (Sq, Sk, Sk))
    before = A.launches
    got = A.fused_attention(q, k, v)
    want = A.attention_reference(q, k, v)
    assert A.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel_err(got, want) <= ATT_TOL[name]


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 4, 130, device=cuda)          # D > 128
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q)
    q = torch.zeros(1, 1, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        A.fused_attention(q, q, q)


@pytest.mark.parametrize("dtype,name", DTYPES)
@pytest.mark.parametrize("H,Cin,width,stride,ds", [
    (64, 64, 64, 1, True),      # stage 0 block 0
    (64, 256, 64, 1, False),    # stage 0 blocks 1-2
    (64, 256, 128, 2, True),    # stage 1 block 0: stride 2 + downsample
    (32, 512, 128, 1, False),   # stage 1 blocks 1-3
    (20, 256, 64, 1, False),    # partial output tiles
    (18, 256, 128, 2, True),    # partial tiles at stride 2
])
def test_bottleneck_kernel_matches_plain(cuda, dtype, name, H, Cin, width,
                                         stride, ds):
    block = Bottleneck(Cin, width, stride, ds)
    init_weights(block, torch.Generator().manual_seed(1))
    block = block.to(cuda, dtype).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, H, H, Cin, device=cuda, generator=g).to(dtype)
    ops = block.fused_operands(dtype)
    before = K.launches
    with torch.inference_mode():
        got = K.fused_bottleneck(x, *ops, stride=stride)
        want = K.bottleneck_reference(x, *ops, stride=stride)
        module = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert K.launches == before + 1
    assert got.shape == (2, H // stride, H // stride, 4 * width)
    assert _rel_err(got, want) <= BLOCK_TOL[name]
    assert _rel_err(got, module) <= BLOCK_TOL[name]


def test_model_with_kernels_matches_model_without(cuda):
    def build(use_kernels):
        return ResnetVQAModel(
            7, vision_model_name="resnet50",
            t5_config=T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                               num_layers=2, num_heads=4),
            num_attention_blocks=2,
            sga_config=AttentionConfig(hidden_size=32, num_heads=4,
                                       ff_size=64),
            use_kernels=use_kernels, device=cuda,
            generator=torch.Generator().manual_seed(3)).eval()

    g = torch.Generator(device=cuda).manual_seed(4)
    batch = {
        "question_input_ids": torch.randint(0, 64, (3, 16), device=cuda,
                                            generator=g),
        "question_attention_masks": torch.ones(3, 16, dtype=torch.int64,
                                               device=cuda),
        "image_tensors": torch.randint(0, 256, (3, 64, 64, 3), device=cuda,
                                       generator=g).to(torch.uint8),
    }
    on, off = build(True), build(False)
    a0, k0 = A.launches, K.launches
    with torch.inference_mode():
        lp_on = on(**batch)[0]
        lp_off = off(**batch)[0]
    assert (A.launches - a0, K.launches - k0) == (4, 7)
    assert torch.isfinite(lp_on).all()
    assert float((lp_on - lp_off).abs().max()) <= 1e-3
