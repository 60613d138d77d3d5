"""Port's bottleneck kernel wrapper and Bottleneck module vs the JAX package.

The JAX side runs ``fused_bottleneck(..., interpret=True)`` (the TPU kernel
body through the Pallas interpreter) and the flax ``Bottleneck``; the port
side runs ``bottleneck_reference`` (the plain version of
``csrc/bottleneck.cu``, which the wrapper takes for CPU tensors) and its
``Bottleneck`` module, on the same numpy weights and inputs, at the three
geometries of tests/test_fused_bottleneck.py (stride 2 included). The BN
parameters are randomised so that the fold is exercised.

Tolerances, as max-abs error relative to max|ref|: fp32 1e-5 (summation
order only); bf16 2e-2, the JAX package's own tolerance for the bf16
re-rounding of the folded weights. The kernel itself runs only on a CUDA
card: ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold it
against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models.resnet import Bottleneck as JaxBottleneck
from t5_resnet_vqa_tpu.ops.pallas.bottleneck import fused_bottleneck as jax_fused
from t5_resnet_vqa_torch.models.resnet import Bottleneck
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.utils.weights import (
    export_conv2d,
    export_frozen_batchnorm,
)

torch.set_num_threads(2)

GEOMETRIES = [
    (16, 64, 64, 1, True),     # stage-0 block 0 (stage entry)
    (16, 256, 64, 1, False),   # stage-0 blocks 1-2
    (16, 256, 128, 2, True),   # stage-1 block 0 (strided + downsample)
]


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _jax_block(H, Cin, width, stride, ds, seed=0):
    """Flax block params (numpy) with random BN and an NHWC input."""
    rng = np.random.default_rng(seed)
    blk = JaxBottleneck(width=width, stride=stride, has_downsample=ds)
    x = rng.standard_normal((2, H, H, Cin), dtype=np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, blk.init(jax.random.PRNGKey(seed), x)["params"])
    for name, sub in params.items():
        if "bn" in name:
            n = sub["scale"].shape[0]
            sub["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            sub["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
    return blk, params, x


def _port_block(params, Cin, width, stride, ds) -> Bottleneck:
    sd = {}
    for c in (1, 2, 3):
        export_conv2d(sd, params[f"conv{c}"], f"conv{c}")
        export_frozen_batchnorm(sd, params[f"bn{c}"], f"bn{c}")
    if ds:
        export_conv2d(sd, params["downsample_conv"], "downsample.0")
        export_frozen_batchnorm(sd, params["downsample_bn"], "downsample.1")
    block = Bottleneck(Cin, width, stride, ds)
    block.load_state_dict(sd, strict=True)
    return block.eval()


@pytest.mark.parametrize("H,Cin,width,stride,ds", GEOMETRIES)
def test_module_matches_flax_block_fp32(H, Cin, width, stride, ds):
    blk, params, x = _jax_block(H, Cin, width, stride, ds)
    want = np.asarray(blk.apply({"params": params}, x))
    block = _port_block(params, Cin, width, stride, ds)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5


@pytest.mark.parametrize("H,Cin,width,stride,ds", GEOMETRIES)
def test_reference_matches_pallas_kernel_body_fp32(H, Cin, width, stride, ds):
    blk, params, x = _jax_block(H, Cin, width, stride, ds)
    want = np.asarray(jax_fused(jnp.asarray(x), params, stride=stride,
                                has_downsample=ds, interpret=True))
    block = _port_block(params, Cin, width, stride, ds)
    with torch.no_grad():
        got = block.forward_fused(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("H,Cin,width,stride,ds", GEOMETRIES)
def test_reference_matches_pallas_kernel_body_bf16(H, Cin, width, stride, ds):
    blk, params, x = _jax_block(H, Cin, width, stride, ds)
    want = jax_fused(jnp.asarray(x, jnp.bfloat16), params, stride=stride,
                     has_downsample=ds, interpret=True)
    assert want.dtype == jnp.bfloat16
    block = _port_block(params, Cin, width, stride, ds).to(torch.bfloat16)
    with torch.no_grad():
        got = block.forward_fused(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2


@pytest.mark.parametrize("H,Cin,width,stride,ds", GEOMETRIES)
def test_fused_and_module_paths_agree(H, Cin, width, stride, ds):
    _, params, x = _jax_block(H, Cin, width, stride, ds, seed=3)
    block = _port_block(params, Cin, width, stride, ds)
    xt = torch.from_numpy(x)
    before = K.launches
    with torch.no_grad():
        fused = block.forward_fused(xt)
        module = block(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert K.launches == before          # CPU: the plain version, no launch
    assert _rel_err(fused.numpy(), module.numpy()) < 1e-5


def test_fold_matches_jax_fold():
    """fold_conv_bn gives the kernel the JAX fold's operands (HWIO * scale,
    tap-major rows, fp32 bias)."""
    _, params, _ = _jax_block(8, 64, 64, 1, True)
    block = _port_block(params, 64, 64, 1, True)
    w2, b2 = K.fold_conv_bn(block.conv2.weight, *block.bn2.folded(),
                            torch.float32)
    kernel = np.asarray(params["conv2"]["kernel"], np.float32)
    want = (kernel * params["bn2"]["scale"]).reshape(-1, kernel.shape[-1])
    np.testing.assert_allclose(w2.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(b2.detach().numpy(), params["bn2"]["bias"],
                               atol=1e-7)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 8, 8, 64), device="meta")
    w = torch.zeros((64, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.fused_bottleneck(x, w, w, w, w, w, w)
