"""Which route of ``csrc/attention.cu`` takes each call, held on the CPU.

``ops/attention._route`` picks the kernel by geometry alone (dtype, D, Sq,
Sk, base addresses and strides), so it runs here on CPU tensors at the
shape of every call site of PERF.md's kernel table: the ViT (S=197) and
RoBERTa (S=213) self-attentions take the TMA + wgmma route, contiguous or
as the head views of [B, S, H*D] projections; the SGA blocks (Sq=16, D=96),
any D other than 64, fp32, and strides or base addresses a tensor map
cannot read keep today's kernels. A forced route the geometry does not
admit raises before anything is built. On the CPU the wrapper still takes
the plain version, which matches the JAX package's attention at the new
route's shapes (fp32, rtol/atol 2e-5, as ``tests/test_torch_attention.py``).
The kernels themselves run only on a card
(``tests/test_torch_kernels_gpu.py``).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.ops import dot_product_attention as jax_attention
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import kernel_build

torch.set_num_threads(2)

# every call site of the kernel table: B, H, Sq, Sk, D and the bf16 route
CALL_SITES = {
    "sga_sk16": (64, 8, 16, 16, 96, "mma_sync"),        # CNN and Faster-RCNN
    "sga_sk64": (64, 8, 16, 64, 96, "mma_sync"),
    "vit_s197": (64, 12, 197, 197, 64, "wgmma"),
    "cross_s213": (64, 12, 213, 213, 64, "wgmma"),
    "sga_sk16_tp2": (64, 4, 16, 16, 96, "mma_sync"),
    "sga_sk64_tp2": (64, 4, 16, 64, 96, "mma_sync"),
    "vit_s197_tp2": (64, 6, 197, 197, 64, "wgmma"),
    "cross_s213_tp2": (64, 6, 213, 213, 64, "wgmma"),
    "vit_s197_dp2": (32, 12, 197, 197, 64, "wgmma"),
}


def _contiguous(B, H, S, D, dtype=torch.bfloat16):
    return torch.empty(B, H, S, D, dtype=dtype)


def _head_views(B, H, S, D, dtype=torch.bfloat16):
    """The head split of a [B, S, H*D] projection, uncopied."""
    return torch.empty(B, S, H * D, dtype=dtype).reshape(B, S, H, D) \
        .transpose(1, 2)


def _qkv(make, B, H, Sq, Sk, D, dtype=torch.bfloat16):
    return make(B, H, Sq, D, dtype), make(B, H, Sk, D, dtype), \
        make(B, H, Sk, D, dtype)


@pytest.mark.parametrize("make", [_contiguous, _head_views],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("site", list(CALL_SITES))
def test_call_sites_take_their_route(site, make):
    B, H, Sq, Sk, D, route = CALL_SITES[site]
    q, k, v = _qkv(make, B, H, Sq, Sk, D)
    A._check(q, k, v)
    assert A._route(q, k, v) == route
    assert A._route(*(t.float() for t in (q, k, v))) == "fp32"


@pytest.mark.parametrize("Sq,Sk,route", [
    (64, 64, "wgmma"),            # the smallest: one query tile, N = 64
    (65, 65, "wgmma"),            # two tiles, keys padded to 80
    (128, 128, "wgmma"),
    (256, 256, "wgmma"),          # four tiles, N = 256
    (197, 64, "wgmma"),           # few keys, four query tiles
    (64, 256, "wgmma"),
    (16, 197, "mma_sync"),        # the SGA's 16 query rows
    (63, 64, "mma_sync"),
    (64, 63, "mma_sync"),
    (257, 64, "mma_sync"),        # more query rows than one box holds
])
def test_route_range(Sq, Sk, route):
    assert A._route(*_qkv(_head_views, 2, 3, Sq, Sk, 64)) == route


@pytest.mark.parametrize("D", [32, 48, 96, 128])
def test_other_head_dims_keep_the_mma_sync_route(D):
    assert A._route(*_qkv(_head_views, 2, 3, 197, 197, D)) == "mma_sync"


def test_fp32_keeps_the_fp32_route():
    q, k, v = _qkv(_contiguous, 2, 3, 197, 197, 64, torch.float32)
    assert A._route(q, k, v) == "fp32"


def test_tma_stride_check_on_strided_views():
    x = _head_views(2, 12, 197, 64)
    assert A._tma_readable(x)
    assert A._tma_readable(x.contiguous())
    # D not contiguous
    assert not A._tma_readable(torch.empty(2, 12, 64, 197,
                                           dtype=torch.bfloat16)
                               .transpose(2, 3))
    # rows 144 bytes apart: 16-byte multiples, readable
    assert A._tma_readable(torch.empty(2, 1, 197, 72, dtype=torch.bfloat16)
                           [..., :64])
    # rows 136 bytes apart: not
    assert not A._tma_readable(torch.empty(2, 1, 197, 68,
                                           dtype=torch.bfloat16)[..., :64])
    # a base 4 bytes past a 16-byte boundary
    buf = torch.empty(2 * 12 * 197 * 64 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    shifted = buf[2:2 + 2 * 12 * 197 * 64].view(2, 12, 197, 64)
    assert shifted.is_contiguous() and not A._tma_readable(shifted)
    # a batch broadcast by a zero stride
    assert not A._tma_readable(torch.empty(1, 12, 197, 64,
                                           dtype=torch.bfloat16)
                               .expand(2, 12, 197, 64))


def test_unreadable_strides_keep_the_mma_sync_route():
    """Calls ``_check`` accepts but a tensor map cannot read."""
    n = 2 * 3 * 197 * 64
    buf = torch.empty(3 * n + 2, dtype=torch.bfloat16)
    shifted = [buf[2 + i * n:2 + (i + 1) * n].view(2, 3, 197, 64)
               for i in range(3)]
    A._check(*shifted)
    assert A._route(*shifted) == "mma_sync"
    q, k, v = _qkv(_head_views, 2, 3, 197, 197, 64)
    expanded = torch.empty(1, 3, 197, 64, dtype=torch.bfloat16) \
        .expand(2, 3, 197, 64)
    A._check(q, expanded, v)
    assert A._route(q, expanded, v) == "mma_sync"
    assert A._route(q, k, v) == "wgmma"


def test_forced_route_refuses_what_the_geometry_does_not_admit():
    """Checked before any kernel is built, so it holds here without nvcc."""
    sga = _qkv(_head_views, 2, 8, 16, 64, 96)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        A._launch(*sga, route="wgmma")
    fp32 = _qkv(_contiguous, 2, 3, 197, 197, 64, torch.float32)
    for route in ("wgmma", "mma_sync"):
        with pytest.raises(ValueError, match=f"route '{route}'"):
            A._launch(*fp32, route=route)
    vit = _qkv(_head_views, 2, 3, 197, 197, 64)
    with pytest.raises(ValueError, match="route 'fp32'"):
        A._launch(*vit, route="fp32")


def test_library_names_follow_the_shared_header(tmp_path, monkeypatch):
    """Both kernels include ``sm90_common.cuh``: an edit there renames, and
    so rebuilds, both libraries."""
    for f in os.listdir(kernel_build.CSRC_DIR):
        shutil.copy(os.path.join(kernel_build.CSRC_DIR, f), tmp_path)
    monkeypatch.setattr(kernel_build, "CSRC_DIR", str(tmp_path))
    names = ("attention", "bottleneck")
    for name in names:
        with open(tmp_path / f"{name}.cu") as f:
            assert '#include "sm90_common.cuh"' in f.read()
    before = {n: kernel_build.library_path(n) for n in names}
    with open(tmp_path / "sm90_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: kernel_build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)


@pytest.mark.parametrize("Sq,Sk", [(197, 197), (213, 213), (65, 65),
                                   (197, 64), (64, 256)])
def test_cpu_wrapper_at_the_route_shapes_matches_jax(Sq, Sk):
    """On CPU tensors of the wgmma route's geometry the wrapper takes the
    plain version (no launch on any route) and matches JAX's attention."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((1, 2, Sq, 64), dtype=np.float32)
    k = rng.standard_normal((1, 2, Sk, 64), dtype=np.float32)
    v = rng.standard_normal((1, 2, Sk, 64), dtype=np.float32)
    before = (A.launches, dict(A.route_launches))
    got = A.fused_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert (A.launches, A.route_launches) == before
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
