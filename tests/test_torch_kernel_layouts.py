"""The layouts around the port's kernels, on the CPU.

* Bottleneck operands: ``pack_operands`` cuts the folded weights into the
  chunks ``csrc/bottleneck.cu`` streams, each as rows of output channels
  with the 128-byte swizzle its ``wgmma`` descriptors read; unpacked they
  are exactly ``fold_conv_bn``'s, and every element sits where the
  kernel's offset formula (written out in the test) puts it.
  ``Bottleneck`` folds and packs once, when its weights
  are set (construction, ``load_state_dict``, a dtype move, ``init_weights``),
  and a later ``load_state_dict`` changes the fused path's output to the new
  weights'. Compared exactly (the same fp32 fold on the same weights) and,
  against the JAX package's flax block, at the tolerance of
  tests/test_torch_bottleneck.py (fp32, 1e-5 relative: summation order).
* Attention views: ``fused_attention`` takes the head views of the
  projections (D contiguous, rows 16-byte aligned) and refuses views it
  cannot read; SGA with ``use_kernel=True`` on such views matches the JAX
  package (fp32, rtol/atol 2e-5, as tests/test_torch_layers.py).
* ``kernel_build.library_path`` hashes the shared headers, so editing one
  rebuilds every kernel (no nvcc needed to check the name).
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models.resnet import Bottleneck as JaxBottleneck
from t5_resnet_vqa_tpu.ops.layers import SGA as JaxSGA, AttentionConfig as JaxCfg
from t5_resnet_vqa_torch.models.resnet import Bottleneck
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import AttentionConfig, SGA
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.ops import kernel_build, layers
from t5_resnet_vqa_torch.utils.weights import (
    export_conv2d,
    export_frozen_batchnorm,
    export_sga_stack,
)

torch.set_num_threads(2)

BLOCKS = [(64, 64, 1, True), (256, 64, 1, False), (256, 128, 2, True),
          (512, 128, 1, False)]


def _block(cin, width, stride, ds, seed=0, dtype=torch.float32):
    block = Bottleneck(cin, width, stride, ds)
    init_weights(block, torch.Generator().manual_seed(seed))
    return block.to(dtype).eval()


def _packed_offset(k, col, K_rows, n):
    """Where the kernel reads element (k, col) of a [K, N] weight packed
    with column blocks of n: block j = col // n, 64-row chunk c = k // 64,
    row r = col % n of 64 channels (128 bytes), the 16-byte piece of
    channel k % 64 XORed with r % 8 (the 128-byte swizzle)."""
    j, r = divmod(col, n)
    c, kk = divmod(k, 64)
    return ((j * (K_rows // 64) + c) * n + r) * 64 \
        + 8 * ((kk // 8) ^ (r % 8)) + kk % 8


# (K, N, n): w1 and w2 at every Cw (n = Cw, one block), w3 and wd at every
# Cw and Cout of the path (n = 128), and K of one chunk
PACK_CASES = [(64, 64, 64), (256, 64, 64), (576, 64, 64), (512, 128, 128),
              (1152, 128, 128), (64, 256, 128), (128, 512, 128),
              (256, 512, 128), (128, 384, 128)]


@pytest.mark.parametrize("n", [64, 128])
def test_pack_weight_round_trip(n):
    w = torch.randn(192, 256, dtype=torch.float64).to(torch.bfloat16)
    packed = K.pack_weight(w, n)
    assert packed.shape == (256 // n, 3, n, 64)
    assert packed.is_contiguous()
    assert torch.equal(K.unpack_weight(packed), w)


@pytest.mark.parametrize("K_rows,N,n", PACK_CASES)
def test_pack_weight_round_trip_at_every_shape(K_rows, N, n):
    w = torch.randn(K_rows, N, dtype=torch.float64).to(torch.bfloat16)
    packed = K.pack_weight(w, n)
    assert packed.shape == (N // n, K_rows // 64, n, 64)
    assert packed.numel() == w.numel()        # no padding
    assert torch.equal(K.unpack_weight(packed), w)


@pytest.mark.parametrize("K_rows,N,n", PACK_CASES)
def test_pack_weight_puts_each_element_where_the_kernel_reads_it(K_rows, N,
                                                                 n):
    # distinct values, exact in bf16 (|v| < 256), so a misplaced element
    # cannot match by accident
    rng = np.random.default_rng(K_rows * 7 + N)
    w = torch.from_numpy(rng.permutation(K_rows * N).reshape(K_rows, N)
                         % 255 - 127).to(torch.bfloat16)
    flat = K.pack_weight(w, n).flatten()
    k, col = np.meshgrid(np.arange(K_rows), np.arange(N), indexing="ij")
    offsets = torch.from_numpy(_packed_offset(k, col, K_rows, n).ravel())
    assert sorted(offsets.tolist()) == list(range(K_rows * N))
    assert torch.equal(flat[offsets], w.flatten())
    # a 64-channel row is 128 contiguous bytes: piece p of row r holds
    # channels 8 (p ^ r % 8)..
    rows = K.pack_weight(w, n).reshape(-1, 64)
    r = 5 % n
    assert torch.equal(rows[r, 8 * (1 ^ (r % 8)):8 * (1 ^ (r % 8)) + 8],
                       w[8:16, r])


@pytest.mark.parametrize("cin,width,stride,ds", BLOCKS)
def test_packed_operands_unpack_to_the_fold(cin, width, stride, ds):
    block = _block(cin, width, stride, ds, dtype=torch.bfloat16)
    plain = block.fused_operands(torch.bfloat16)
    packed = block.fused
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(packed.plain, plain))
    w1, b1, w2, b2, w3, b3, wd, bd = packed.kernel
    # chunk order: w1/w2 one column block of 64-row chunks; w3/wd column
    # blocks of 128, each split into 64-row chunks; a chunk is its columns
    # as rows of 64 channels
    assert w1.shape == (1, cin // 64, width, 64)
    assert w2.shape == (1, 9 * width // 64, width, 64)
    assert w3.shape == (4 * width // 128, width // 64, 128, 64)
    if ds:
        assert wd.shape == (4 * width // 128, cin // 64, 128, 64)
    unpacked = [K.unpack_weight(w) if w is not None and w.dim() == 4 else w
                for w in packed.kernel]
    for got, want in zip(unpacked, plain):
        assert (got is None and want is None) or torch.equal(got, want)
    assert (wd is None) == (not ds) and (bd is None) == (not ds)


def test_fp32_operands_are_the_fold_unpacked():
    block = _block(256, 64, 1, False)
    assert block.fused.kernel is block.fused.plain
    for got, want in zip(block.fused.plain, block.fused_operands(torch.float32)):
        assert (got is None and want is None) or torch.equal(got, want)


def test_operands_follow_a_dtype_move():
    block = _block(64, 64, 1, True)
    assert block.fused.plain[0].dtype == torch.float32
    block = block.to(torch.bfloat16)
    assert block.fused.plain[0].dtype == torch.bfloat16
    assert block.fused.kernel[0].shape == (1, 1, 64, 64)
    for got, want in zip(block.fused.plain,
                         block.fused_operands(torch.bfloat16)):
        assert (got is None and want is None) or torch.equal(got, want)


@pytest.mark.parametrize("cin,width,stride,ds", BLOCKS[:3])
def test_load_state_dict_after_a_forward_takes_the_new_weights(cin, width,
                                                               stride, ds):
    block = _block(cin, width, stride, ds, seed=1)
    x = torch.randn(2, 8, 8, cin, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        first = block.forward_fused(x)
        other = _block(cin, width, stride, ds, seed=3)
        block.load_state_dict(other.state_dict())
        got = block.forward_fused(x)
        want = K.bottleneck_reference(
            x, *other.fused_operands(torch.float32), stride=stride)
        module = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert not torch.equal(got, first)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, module, rtol=1e-5, atol=1e-5)


def test_loaded_jax_weights_reach_the_fused_path():
    """A strict load of the flax block's weights into a block built with
    other weights: the fused path then matches the flax block."""
    rng = np.random.default_rng(4)
    blk = JaxBottleneck(width=64, stride=2, has_downsample=True)
    x = rng.standard_normal((2, 8, 8, 64), dtype=np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, blk.init(jax.random.PRNGKey(4), x)["params"])
    for name, sub in params.items():
        if "bn" in name:
            n = sub["scale"].shape[0]
            sub["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            sub["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
    want = np.asarray(blk.apply({"params": params}, x))
    sd = {}
    for c in (1, 2, 3):
        export_conv2d(sd, params[f"conv{c}"], f"conv{c}")
        export_frozen_batchnorm(sd, params[f"bn{c}"], f"bn{c}")
    export_conv2d(sd, params["downsample_conv"], "downsample.0")
    export_frozen_batchnorm(sd, params["downsample_bn"], "downsample.1")
    block = _block(64, 64, 2, True, seed=5)
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block.forward_fused(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 1e-5


def _head_views(B, S, H, D, dtype=torch.float32, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, S, H * D), dtype=np.float32)).to(dtype)
    return x.reshape(B, S, H, D).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,D", [(2, 16, 64, 8, 96),
                                         (2, 197, 197, 12, 64),
                                         (3, 20, 20, 4, 8)])
def test_attention_accepts_head_views(dtype, B, Sq, Sk, H, D):
    q = _head_views(B, Sq, H, D, dtype, 0)
    k = _head_views(B, Sk, H, D, dtype, 1)
    assert not q.is_contiguous()
    A._check(q, k, k)
    A._check(q.contiguous(), k.contiguous(), k.contiguous())


def test_attention_refuses_views_it_cannot_read():
    base = torch.zeros(1, 1, 4, 14, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A._check(*[base[..., :6]] * 3)            # rows 28 bytes apart
    q = torch.zeros(1, 1, 8, 4).transpose(2, 3)   # D not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        A._check(q, q, q)


@pytest.mark.parametrize("guide", [16, 64])
def test_sga_through_the_kernel_route_matches_jax(guide, monkeypatch):
    """SGA with the kernel route on, against the JAX SGA with its Pallas
    route on (interpreted on the CPU): the wrapper is handed the head views
    of the projections, uncopied, and accepts them."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 32), dtype=np.float32)
    y = rng.standard_normal((2, guide, 32), dtype=np.float32)
    jax_block = JaxSGA(JaxCfg(hidden_size=32, num_heads=4, ff_size=64),
                       use_pallas=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax_block.init(jax.random.PRNGKey(6), x, y)["params"])
    want = np.asarray(jax_block.apply({"params": params}, x, y))
    sd = {}
    export_sga_stack(sd, {"sga_0": params}, 1, prefix="stack")
    block = SGA(AttentionConfig(hidden_size=32, num_heads=4, ff_size=64),
                use_kernel=True)
    block.load_state_dict({k[len("stack.0."):]: v for k, v in sd.items()},
                          strict=True)
    seen = []

    def spy(q, k, v):
        seen.append(all(not t.is_contiguous() for t in (q, k, v)))
        A._check(q, k, v)
        return A.fused_attention(q, k, v)

    monkeypatch.setattr(layers, "fused_attention", spy)
    before = A.launches
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert seen == [True, True]
    assert A.launches == before          # CPU: the plain version
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_library_name_covers_shared_headers(tmp_path, monkeypatch):
    for f in os.listdir(kernel_build.CSRC_DIR):
        shutil.copy(os.path.join(kernel_build.CSRC_DIR, f), tmp_path)
    monkeypatch.setattr(kernel_build, "CSRC_DIR", str(tmp_path))
    headers = [f for f in os.listdir(tmp_path) if f.endswith(".cuh")]
    assert headers
    before = {n: kernel_build.library_path(n)
              for n in ("attention", "bottleneck")}
    assert before == {n: kernel_build.library_path(n) for n in before}
    with open(tmp_path / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = {n: kernel_build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    with open(tmp_path / "attention.cu", "a") as f:
        f.write("\n// edited\n")
    assert kernel_build.library_path("attention") != after["attention"]
    assert kernel_build.library_path("bottleneck") == after["bottleneck"]
