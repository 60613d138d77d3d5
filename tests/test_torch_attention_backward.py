"""Kernel 1's backward, held on the CPU.

``ops/attention.attention_backward`` is the backward of the port's fused
attention: on a card, the hand-written kernel of
``csrc/attention_bwd.cu`` where the forward takes the TMA + wgmma route,
and the VJP of ``attention_reference`` elsewhere; on CPU tensors always
that plain VJP, which launches nothing and counts nothing. Here the plain
VJP is held against ``jax.vjp`` of the JAX package's
``fused_attention_grad_safe`` (its custom VJP ``_fas_bwd`` runs off the
TPU) on the same numpy inputs: fp32 within rtol/atol 2e-5 (the sums run
in another order), bf16 within 1e-2 of max|ref| (both round P, dP and the
outputs to bf16, at the same points; the products' fp32 sums run in
another order, so a rounding can land one bf16 ulp apart). The route the
backward takes is held by geometry, as ``tests/test_torch_attention_route.py``
holds the forward's. The kernel itself runs only on a card
(``tests/test_torch_kernels_gpu.py``).

The backward kernel's row statistics have plain versions here too: each
row's (m, l), the scaled max and the sum of 2^(s c - m) that the forward
kernel writes and the backward forms P from, as the log-sum-exp they give,
against ``jax.nn.logsumexp`` of the scaled scores, fp32 within rtol/atol
2e-5; and the reference's delta, sum_j P * bf16(dP) (not
FlashAttention's rowsum(dO * O)), against numpy: fp32 within 2e-5, bf16
within 1e-3 of max|delta| (dP is rounded to bf16 in both, from fp32 sums
in another order, so a rounding can land one bf16 ulp apart).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.ops.pallas.attention import fused_attention_grad_safe
from t5_resnet_vqa_torch.ops import attention as A

torch.set_num_threads(2)

# (Sq, Sk, D) at B=1, H=2: the ViT (S=197) and RoBERTa (S=213)
# self-attentions, the wgmma route's edges, and the SGA blocks (D=96)
VJP_SHAPES = [(197, 197, 64), (213, 213, 64), (197, 64, 64), (64, 64, 64),
              (256, 256, 64), (64, 256, 64), (16, 16, 96), (16, 64, 96)]


def _inputs(Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, Sq, D), dtype=np.float32)
    k = rng.standard_normal((1, 2, Sk, D), dtype=np.float32)
    v = rng.standard_normal((1, 2, Sk, D), dtype=np.float32)
    g = rng.standard_normal((1, 2, Sq, D), dtype=np.float32)
    return q, k, v, g


def _jax_vjp(q, k, v, g, dtype):
    args = [jnp.asarray(x, dtype=dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(fused_attention_grad_safe, *args)
    return [np.asarray(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(g, dtype=dtype))]


@pytest.mark.parametrize("Sq,Sk,D", VJP_SHAPES)
def test_plain_vjp_matches_jax_fp32(Sq, Sk, D):
    q, k, v, g = _inputs(Sq, Sk, D, seed=Sq * 7 + Sk + D)
    got = A.attention_backward(*map(torch.from_numpy, (q, k, v, g)))
    want = _jax_vjp(q, k, v, g, jnp.float32)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("Sq,Sk,D", VJP_SHAPES)
def test_plain_vjp_matches_jax_bf16(Sq, Sk, D):
    q, k, v, g = _inputs(Sq, Sk, D, seed=Sq * 11 + Sk + D)
    got = A.attention_backward(*(torch.from_numpy(x).to(torch.bfloat16)
                                 for x in (q, k, v, g)))
    want = _jax_vjp(q, k, v, g, jnp.bfloat16)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, name
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-2, f"d{name}: {err} of max|ref|"


@pytest.mark.parametrize("Sq,Sk,D", VJP_SHAPES)
def test_plain_stats_match_jax_logsumexp(Sq, Sk, D):
    q, k, _, _ = _inputs(Sq, Sk, D, seed=Sq * 5 + Sk + D)
    stats = A.attention_stats_reference(torch.from_numpy(q),
                                        torch.from_numpy(k))
    assert stats.dtype == torch.float32 and stats.shape == (1, 2, Sq, 2)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    np.testing.assert_allclose(
        stats[..., 0].numpy(),
        np.asarray(scores.max(-1)) * np.log2(np.e), rtol=2e-5, atol=2e-5)
    assert (stats[..., 1] >= 1).all()     # the max's own term is 2^0
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    np.testing.assert_allclose(_lse(stats).numpy(), want,
                               rtol=2e-5, atol=2e-5)


def _lse(stats):
    """Each row's log-sum-exp of the scaled scores (natural log) from its
    statistics (m, l): (m + log2 l) ln 2."""
    return (stats[..., 0] + torch.log2(stats[..., 1])) * np.log(2.0)


def _delta_reference(q, k, v, g):
    """The backward's other row statistic, fp32 [B, H, Sq], as autograd of
    ``attention_reference`` forms it and the kernel's rounding contract
    keeps it: delta = sum_j P * dP, with P the fp32 softmax and dP = g v^T
    rounded to q's dtype (not FlashAttention's rowsum(g * out))."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(scores / np.sqrt(q.shape[-1]), dim=-1)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return (p * dp.to(q.dtype).float()).sum(-1)


def _numpy_delta(q, k, v, g, bf16):
    """sum_j P * dP per row in float64, with dP rounded to bf16 where the
    inputs are bf16."""
    if bf16:
        q, k, v, g = (x.astype(ml_dtypes.bfloat16).astype(np.float64)
                      for x in (q, k, v, g))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = np.einsum("bhqd,bhkd->bhqk", g, v)
    if bf16:
        dp = dp.astype(np.float32).astype(ml_dtypes.bfloat16) \
            .astype(np.float64)
    return (p * dp).sum(-1)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("Sq,Sk,D", [(197, 197, 64), (213, 213, 64),
                                     (64, 256, 64), (16, 64, 96)])
def test_plain_delta_matches_numpy(Sq, Sk, D, bf16):
    q, k, v, g = _inputs(Sq, Sk, D, seed=Sq * 13 + Sk + D)
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = _delta_reference(*(torch.from_numpy(x).to(dtype)
                             for x in (q, k, v, g)))
    want = _numpy_delta(q, k, v, g, bf16)
    assert got.dtype == torch.float32 and got.shape == (1, 2, Sq)
    if bf16:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-3, err
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_no_statistics():
    """CPU tensors neither save statistics in the forward nor take them in
    the backward: ``fused_attention`` is the plain version, and
    ``attention_backward`` the plain VJP whatever ``stats`` it is given,
    with every counter left alone."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(213, 213, 64, seed=8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    assert A._route(*leaves) == "wgmma"
    assert not A._saves_stats(*leaves)
    counters = lambda: (A.launches, A.stats_launches,
                        A.bwd_stats_recomputed, dict(A.bwd_route_launches))
    before = counters()
    out = A.fused_attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    want = A.attention_backward(q, k, v, g)
    bogus = torch.full((1, 2, 213, 2), float("nan"))
    given = A.attention_backward(q, k, v, g, stats=bogus)
    assert counters() == before
    for a, b, c in zip(got, want, given):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(c, b, rtol=0, atol=0)


# every call site of PERF.md's kernel table: B, H, Sq, Sk, D and the route of
# its bf16 backward
CALL_SITES = {
    "sga_sk16": (64, 8, 16, 16, 96, "plain"),
    "sga_sk64": (64, 8, 16, 64, 96, "plain"),
    "vit_s197": (64, 12, 197, 197, 64, "wgmma"),
    "cross_s213": (64, 12, 213, 213, 64, "wgmma"),
    "sga_sk16_tp2": (64, 4, 16, 16, 96, "plain"),
    "sga_sk64_tp2": (64, 4, 16, 64, 96, "plain"),
    "vit_s197_tp2": (64, 6, 197, 197, 64, "wgmma"),
    "cross_s213_tp2": (64, 6, 213, 213, 64, "wgmma"),
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
def test_call_sites_take_their_backward_route(site, make):
    B, H, Sq, Sk, D, route = CALL_SITES[site]
    q, k, v = _qkv(make, B, H, Sq, Sk, D)
    assert A._bwd_route(q, k, v) == route
    assert A._bwd_route(*(t.float() for t in (q, k, v))) == "plain"


@pytest.mark.parametrize("Sq,Sk,route", [
    (64, 64, "wgmma"), (65, 65, "wgmma"), (128, 128, "wgmma"),
    (256, 256, "wgmma"), (197, 64, "wgmma"), (64, 256, "wgmma"),
    (16, 197, "plain"), (63, 64, "plain"), (64, 63, "plain"),
    (257, 64, "plain"),
])
def test_backward_route_range(Sq, Sk, route):
    """The backward takes the kernel exactly where the forward takes the
    wgmma route."""
    q, k, v = _qkv(_head_views, 2, 3, Sq, Sk, 64)
    assert A._bwd_route(q, k, v) == route
    assert (A._route(q, k, v) == "wgmma") == (route == "wgmma")


@pytest.mark.parametrize("D", [32, 48, 96, 128])
def test_other_head_dims_take_the_plain_vjp(D):
    assert A._bwd_route(*_qkv(_head_views, 2, 3, 197, 197, D)) == "plain"


def test_unreadable_strides_take_the_plain_vjp():
    n = 2 * 3 * 197 * 64
    buf = torch.empty(3 * n + 2, dtype=torch.bfloat16)
    shifted = [buf[2 + i * n:2 + (i + 1) * n].view(2, 3, 197, 64)
               for i in range(3)]
    A._check(*shifted)
    assert A._bwd_route(*shifted) == "plain"
    q, k, v = _qkv(_head_views, 2, 3, 197, 197, 64)
    expanded = torch.empty(1, 3, 197, 64, dtype=torch.bfloat16) \
        .expand(2, 3, 197, 64)
    assert A._bwd_route(q, expanded, v) == "plain"
    assert A._bwd_route(q, k, v) == "wgmma"


def test_forced_backward_route():
    """``"plain"`` is taken on any geometry, ``"wgmma"`` only where the
    geometry admits it; checked before anything is built."""
    vit = _qkv(_head_views, 2, 3, 197, 197, 64)
    sga = _qkv(_head_views, 2, 8, 16, 64, 96)
    fp32 = _qkv(_contiguous, 2, 3, 197, 197, 64, torch.float32)
    assert A._forced_bwd_route(*vit, None) == "wgmma"
    assert A._forced_bwd_route(*vit, "plain") == "plain"
    assert A._forced_bwd_route(*sga, None) == "plain"
    for args in (sga, fp32):
        with pytest.raises(ValueError, match="backward route 'wgmma'"):
            A._forced_bwd_route(*args, "wgmma")
    with pytest.raises(ValueError, match="backward route 'mma_sync'"):
        A._forced_bwd_route(*vit, "mma_sync")


def test_readable_grad_reads_the_main_paths_gradient_in_place():
    """The gradient of the forward's output, as the callers' head merge
    hands it back (the [B, H, Sq, D] view of a contiguous [B, Sq, H, D]),
    and a contiguous one are read in place; a broadcast or a misaligned one
    is copied, and the copy counted."""
    B, H, Sq, D = 2, 12, 197, 64
    main = torch.zeros(B, Sq, H, D, dtype=torch.bfloat16).transpose(1, 2)
    flat = torch.zeros(B, H, Sq, D, dtype=torch.bfloat16)
    before = A.bwd_grad_copies
    for g in (main, flat):
        assert A._readable_grad(g) is g
    assert A.bwd_grad_copies == before
    ones = torch.ones((), dtype=torch.bfloat16).expand(B, H, Sq, D)
    buf = torch.zeros(B * H * Sq * D + 2, dtype=torch.bfloat16)
    shifted = buf[2:].view(B, H, Sq, D)
    for i, g in enumerate((ones, shifted), start=1):
        got = A._readable_grad(g)
        assert got is not g and got.is_contiguous() and A._tma_readable(got)
        torch.testing.assert_close(got, g, rtol=0, atol=0)
        assert A.bwd_grad_copies == before + i


def test_cpu_backward_launches_nothing():
    """CPU tensors of the wgmma route's geometry take the plain VJP, through
    ``attention_backward`` and through the autograd function's backward,
    and leave every counter alone."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(197, 197, 64, seed=3))
    assert A._bwd_route(q, k, v) == "wgmma"
    counters = lambda: (A.launches, dict(A.route_launches),
                        dict(A.bwd_route_launches), A.bwd_grad_copies,
                        A.stats_launches, A.bwd_stats_recomputed)
    before = counters()
    A.attention_backward(q, k, v, g)
    ctx = type("Ctx", (), {"saved_tensors": (q, k, v)})()
    A._FusedAttention.backward(ctx, g)
    assert counters() == before
    with pytest.raises(ValueError, match="CPU tensors take the plain VJP"):
        A.attention_backward(q, k, v, g, route="wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forced_plain_route_is_autograd_of_the_reference(dtype):
    """``route="plain"`` is the plain version's own backward, to the bit."""
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(213, 213, 64, seed=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(A.attention_reference(*leaves), leaves, g)
    got = A.attention_backward(q, k, v, g, route="plain")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
