"""Which route of ``csrc/attention.cu`` takes each call, held on the CPU.

``ops/attention._route`` picks the kernel by geometry alone (dtype, D, Sq,
Sk, base addresses and strides), so it runs here on CPU tensors at the
shape of every call site of PERF.md's kernel table: the ViT (S=197) and
RoBERTa (S=213) self-attentions take the TMA + wgmma route, contiguous or
as the head views of [B, S, H*D] projections; the SGA blocks (Sq=16,
Sk=16 and 64, D=96, H=8 and 4) the short_kv route (1 <= Sq, Sk <= 64, D a
multiple of 16); more keys, other D, fp32, and strides or base addresses
a tensor map cannot read keep the mma_sync and fp32 kernels. A forced
route the geometry does not admit raises before anything is built. On the
CPU the wrapper still takes the plain version, which matches the JAX
package's attention at the new routes' shapes (fp32, rtol/atol 2e-5, as
``tests/test_torch_attention.py``); the short_kv kernel's arithmetic
(padding, masking, one-pass softmax, rounding points), written out in
numpy, matches the plain version and JAX in bf16. The kernels themselves
run only on a card (``tests/test_torch_kernels_gpu.py``).
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
    "sga_sk16": (64, 8, 16, 16, 96, "short_kv"),        # CNN and Faster-RCNN
    "sga_sk64": (64, 8, 16, 64, 96, "short_kv"),
    "vit_s197": (64, 12, 197, 197, 64, "wgmma"),
    "cross_s213": (64, 12, 213, 213, 64, "wgmma"),
    "sga_sk16_tp2": (64, 4, 16, 16, 96, "short_kv"),
    "sga_sk64_tp2": (64, 4, 16, 64, 96, "short_kv"),
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
    (63, 64, "short_kv"),         # below the wgmma route's 64 query rows
    (64, 63, "short_kv"),         # below its 64 keys
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


# the short_kv route's edges: Sq, Sk, D and the route each must take
SHORT_KV_EDGES = [
    (16, 64, 96, "short_kv"),     # the SGA's guided attention, block 0
    (16, 65, 96, "mma_sync"),     # one key past the route
    (64, 16, 96, "short_kv"),
    (65, 16, 96, "mma_sync"),     # one query row past it
    (1, 1, 96, "short_kv"),
    (17, 15, 96, "short_kv"),     # ragged query and key tiles
    (16, 16, 16, "short_kv"),     # the smallest D
    (16, 16, 128, "short_kv"),    # the largest
    (16, 16, 72, "mma_sync"),     # D not a multiple of 16
    (16, 16, 8, "mma_sync"),
    (64, 64, 64, "wgmma"),        # the wgmma route keeps its corner
    (64, 64, 96, "short_kv"),
    (63, 63, 64, "short_kv"),
    (16, 197, 96, "mma_sync"),    # more keys than a row of registers holds
    (16, 197, 64, "mma_sync"),
]


@pytest.mark.parametrize("make", [_contiguous, _head_views],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("Sq,Sk,D,route", SHORT_KV_EDGES)
def test_short_kv_route_edges(Sq, Sk, D, route, make):
    q, k, v = _qkv(make, 2, 3, Sq, Sk, D)
    A._check(q, k, v)
    assert A._route(q, k, v) == route


def test_short_kv_head_dim_past_the_kernels_is_refused():
    """D=136 is refused by ``_check`` before any route is picked."""
    for make in (_contiguous, _head_views):
        with pytest.raises(ValueError, match="D <= 128"):
            A._check(*_qkv(make, 2, 3, 16, 16, 136))


def test_short_kv_unreadable_strides_keep_the_mma_sync_route():
    """The SGA's geometry with a base a tensor map cannot read, or a batch
    broadcast by a zero stride, stays on the mma_sync route."""
    n = 2 * 8 * 16 * 96
    buf = torch.empty(3 * n + 2, dtype=torch.bfloat16)
    shifted = [buf[2 + i * n:2 + (i + 1) * n].view(2, 8, 16, 96)
               for i in range(3)]
    A._check(*shifted)
    assert A._route(*shifted) == "mma_sync"
    q, k, v = _qkv(_head_views, 2, 8, 16, 64, 96)
    assert A._route(q, k, v) == "short_kv"
    expanded = torch.empty(1, 8, 64, 96, dtype=torch.bfloat16) \
        .expand(2, 8, 64, 96)
    A._check(q, expanded, v)
    assert A._route(q, expanded, v) == "mma_sync"
    assert A._route(q, k, expanded) == "mma_sync"


@pytest.mark.parametrize("site", [s for s in CALL_SITES
                                  if CALL_SITES[s][5] == "short_kv"])
def test_short_kv_backward_takes_the_plain_vjp(site):
    B, H, Sq, Sk, D, _ = CALL_SITES[site]
    for make in (_contiguous, _head_views):
        q, k, v = _qkv(make, B, H, Sq, Sk, D)
        assert A._route(q, k, v) == "short_kv"
        assert A._bwd_route(q, k, v) == "plain"


def test_forced_route_on_short_kv_calls():
    """``mma_sync`` is admitted on a short_kv call (the smoke and the GPU
    tests time the two in turns); any other forced route is refused, and
    ``short_kv`` is refused where the geometry is another route's."""
    sga = _qkv(_head_views, 2, 8, 16, 64, 96)
    assert A._forced_route(*sga, None) == "short_kv"
    assert A._forced_route(*sga, "short_kv") == "short_kv"
    assert A._forced_route(*sga, "mma_sync") == "mma_sync"
    for route in ("wgmma", "fp32"):
        with pytest.raises(ValueError, match=f"route '{route}'"):
            A._forced_route(*sga, route)
    others = (_qkv(_head_views, 2, 3, 197, 197, 64),          # wgmma
              _qkv(_head_views, 2, 3, 16, 16, 72),            # mma_sync
              _qkv(_contiguous, 2, 3, 16, 16, 96, torch.float32))
    for q, k, v in others:
        with pytest.raises(ValueError, match="route 'short_kv'"):
            A._forced_route(q, k, v, "short_kv")
        with pytest.raises(ValueError, match="route 'short_kv'"):
            A._launch(q, k, v, route="short_kv")


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


# the short_kv route's shapes on the CPU: the SGA's and the edges
SHORT_KV_SHAPES = [(16, 16, 96), (16, 64, 96), (1, 1, 96), (17, 63, 96),
                   (64, 64, 128), (16, 15, 16)]


@pytest.mark.parametrize("Sq,Sk,D", SHORT_KV_SHAPES)
def test_cpu_wrapper_at_the_short_kv_shapes_matches_jax(Sq, Sk, D):
    """On CPU tensors of the short_kv route's geometry the wrapper takes
    the plain version (no launch on any route) and matches JAX's attention
    (fp32, rtol/atol 2e-5)."""
    rng = np.random.default_rng(Sq * 100 + Sk + D)
    q = rng.standard_normal((2, 3, Sq, D), dtype=np.float32)
    k = rng.standard_normal((2, 3, Sk, D), dtype=np.float32)
    v = rng.standard_normal((2, 3, Sk, D), dtype=np.float32)
    before = (A.launches, dict(A.route_launches))
    got = A.fused_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert (A.launches, A.route_launches) == before
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _short_kv_arithmetic(q, k, v):
    """The short_kv kernel's arithmetic in numpy, for one tile of 16 query
    rows at a time: keys and values padded with zero rows to 16-key tiles,
    padded keys -inf, P = 2^(S c - max c) with c = log2(e) / sqrt(D),
    normalised in fp32 and then rounded to bf16, P V in fp32, the output
    rounded to bf16."""
    import ml_dtypes

    bf16 = ml_dtypes.bfloat16
    Sk, D = k.shape[2], k.shape[3]
    pad = -Sk % 16
    kp = np.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)))
    s = np.einsum("bhqd,bhkd->bhqk", q, kp, dtype=np.float32)
    s[..., Sk:] = -np.inf
    c = np.float32(np.log2(np.e) / np.sqrt(D))
    mx = s.max(-1, keepdims=True) * c
    p = np.exp2(s * c - mx).astype(np.float32)
    p = (p * (np.float32(1) / p.sum(-1, keepdims=True))).astype(bf16)
    o = np.einsum("bhqk,bhkd->bhqd", p.astype(np.float32), vp,
                  dtype=np.float32)
    return o.astype(bf16).astype(np.float32)


@pytest.mark.parametrize("Sq,Sk,D", SHORT_KV_SHAPES)
def test_short_kv_arithmetic_matches_the_plain_version_in_bf16(Sq, Sk, D):
    """The kernel's arithmetic (padding, masking, one-pass softmax, its
    rounding points) against the plain version and JAX's attention on the
    same bf16 inputs: within 1e-2 of max|ref|, the GPU tests' bf16
    tolerance (sums in another order, exp2 in place of exp)."""
    import ml_dtypes

    rng = np.random.default_rng(Sq + 7 * Sk + D)
    q, k, v = (rng.standard_normal((2, 3, s, D), dtype=np.float32)
               .astype(ml_dtypes.bfloat16) for s in (Sq, Sk, Sk))
    got = _short_kv_arithmetic(*(t.astype(np.float32) for t in (q, k, v)))
    plain = A.attention_reference(
        *(torch.from_numpy(t.astype(np.float32)).to(torch.bfloat16)
          for t in (q, k, v))).float().numpy()
    jax_out = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))),
                         dtype=np.float32)
    for want in (plain, jax_out):
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
