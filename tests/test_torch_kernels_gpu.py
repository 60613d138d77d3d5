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
fp32: log-probs within 1e-3. The attention backward kernel against the
plain VJP: bf16 1e-2 for each of dq, dk and dv (the kernel rounds dS to a
hi and a lo bf16 part where the plain VJP keeps it fp32). The forward's row
statistics (each row's scaled max m and sum l) against
``attention_stats_reference``, as the log-sum-exp they give: 1e-5 of
max(1, max|ref|) (the same bf16 inputs; fp32 sums in another
order, and the SFU's approximate exp2).
"""

import math

import pytest
import torch

from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.models.resnet import Bottleneck
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.ops import kernel_build

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, "fp32"), (torch.bfloat16, "bf16")]
ATT_TOL = {"fp32": 1e-5, "bf16": 1e-2}
LSE_TOL = 1e-5
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


@pytest.mark.parametrize("dtype,name", DTYPES)
@pytest.mark.parametrize("B,H,Sq,Sk,D", [
    (4, 8, 16, 64, 96),      # SGA: the head views of the projections
    (2, 12, 197, 197, 64),   # ViT
    (3, 4, 20, 20, 8),       # D=8, Sk not a multiple of 16
    (2, 2, 33, 45, 40),      # D not a multiple of 16, three query tiles
])
def test_attention_kernel_reads_head_views(cuda, dtype, name, B, H, Sq, Sk,
                                           D):
    """q, k, v as [B, S, H*D] projections split into heads without a copy;
    the output is the [B, H, Sq, D] view of a contiguous [B, Sq, H, D]."""
    g = torch.Generator(device=cuda).manual_seed(5)

    def heads(s):
        x = torch.randn(B, s, H * D, device=cuda, generator=g).to(dtype)
        return x.reshape(B, s, H, D).transpose(1, 2)

    q, k, v = heads(Sq), heads(Sk), heads(Sk)
    assert not q.is_contiguous()
    before = A.launches
    got = A.fused_attention(q, k, v)
    want = A.attention_reference(q, k, v)
    assert A.launches == before + 1
    assert got.shape == (B, H, Sq, D) and got.transpose(1, 2).is_contiguous()
    assert _rel_err(got, want) <= ATT_TOL[name]


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 4, 130, device=cuda)          # D > 128
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q)
    q = torch.zeros(1, 1, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        A.fused_attention(q, q, q)
    # a view whose rows (14 bf16 = 28 bytes apart) are not 16-byte aligned
    q = torch.zeros(1, 1, 4, 14, device=cuda, dtype=torch.bfloat16)[..., :6]
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q)


# the wgmma route's shapes: the ViT (S=197) and RoBERTa (S=213)
# self-attentions, at H=12 and at a tp=2 rank's H=6, and the edges of its
# range (64 <= Sq, Sk <= 256; Sk not a multiple of 16; one and four query
# tiles)
TMA_SHAPES = [
    (2, 12, 197, 197),
    (2, 12, 213, 213),
    (2, 6, 197, 197),
    (2, 6, 213, 213),
    (1, 2, 64, 64),
    (1, 2, 65, 65),
    (1, 2, 128, 128),
    (1, 2, 256, 256),
    (2, 3, 197, 64),
    (2, 3, 64, 256),
]


def _bf16_inputs(cuda, B, H, Sq, Sk, D, views, seed):
    """q, k, v in bf16: contiguous [B, H, S, D], or the head views of
    [B, S, H*D] projections as the main path hands them over."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if not views:
        return [torch.randn(B, H, s, D, device=cuda, generator=g)
                .to(torch.bfloat16) for s in (Sq, Sk, Sk)]
    return [torch.randn(B, s, H * D, device=cuda, generator=g)
            .to(torch.bfloat16).reshape(B, s, H, D).transpose(1, 2)
            for s in (Sq, Sk, Sk)]


@pytest.mark.parametrize("views", [False, True],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("B,H,Sq,Sk", TMA_SHAPES)
def test_attention_wgmma_route_matches_plain(cuda, views, B, H, Sq, Sk):
    """The TMA + wgmma route against the plain version, and today's
    mma.sync route (forced) against it on the same inputs."""
    q, k, v = _bf16_inputs(cuda, B, H, Sq, Sk, 64, views, seed=8)
    assert A._route(q, k, v) == "wgmma"
    before = dict(A.route_launches)
    got = A.fused_attention(q, k, v)
    want = A.attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert A.route_launches["wgmma"] == before["wgmma"] + 1
    assert A.route_launches["mma_sync"] == before["mma_sync"]
    assert got.shape == (B, H, Sq, 64) and got.transpose(1, 2).is_contiguous()
    assert _rel_err(got, want) <= ATT_TOL["bf16"]
    old = A._launch(q, k, v, route="mma_sync")
    assert A.route_launches["mma_sync"] == before["mma_sync"] + 1
    assert _rel_err(old, want) <= ATT_TOL["bf16"]


def test_attention_other_geometries_keep_their_routes(cuda):
    """The SGA's 16 query rows over 197 keys, D=96, a contiguous tensor
    whose base is only 4-byte aligned, and fp32 stay off the wgmma route,
    and each still matches the plain version."""
    q16, k197, v197 = _bf16_inputs(cuda, 2, 4, 16, 197, 64, True, seed=9)
    q96, k96, v96 = _bf16_inputs(cuda, 2, 4, 197, 197, 96, False, seed=10)
    n = 2 * 4 * 197 * 64
    buf = torch.randn(3 * n + 2, device=cuda).to(torch.bfloat16)
    shifted = [buf[2 + i * n:2 + (i + 1) * n].view(2, 4, 197, 64)
               for i in range(3)]
    fp32 = [t.float() for t in _bf16_inputs(cuda, 2, 4, 197, 197, 64, False,
                                             seed=11)]
    for (q, k, v), route in (((q16, k197, v197), "mma_sync"),
                             ((q96, k96, v96), "mma_sync"),
                             (shifted, "mma_sync"),
                             (fp32, "fp32")):
        assert A._route(q, k, v) == route
        before = A.route_launches[route]
        got = A.fused_attention(q, k, v)
        want = A.attention_reference(q, k, v)
        torch.cuda.synchronize()
        assert A.route_launches[route] == before + 1
        tol = ATT_TOL["fp32" if route == "fp32" else "bf16"]
        assert _rel_err(got, want) <= tol


def test_attention_forced_route_refuses_what_it_does_not_take(cuda):
    q, k, v = _bf16_inputs(cuda, 2, 4, 16, 64, 96, True, seed=12)
    with pytest.raises(ValueError):
        A._launch(q, k, v, route="wgmma")                 # D=96, Sq=16
    f = [t.float() for t in (q, k, v)]
    for route in ("wgmma", "mma_sync"):
        with pytest.raises(ValueError):
            A._launch(*f, route=route)
    q, k, v = _bf16_inputs(cuda, 2, 4, 197, 197, 64, True, seed=13)
    with pytest.raises(ValueError):
        A._launch(q, k, v, route="fp32")


# the short_kv route: the SGA's four cases (B=64; H=8, and a tp=2 rank's
# H=4; Sk=16 and 64; D=96), then the edges of its domain (1 <= Sq, Sk <= 64,
# D a multiple of 16 up to 128: ragged key and query tiles, the smallest and
# largest D) and batches that wrap each block's ring of stages several
# times (4096 and 2048 heads over at most 132 blocks)
SGA_SHAPES = [(64, 8, 16, 16), (64, 8, 16, 64), (64, 4, 16, 16),
              (64, 4, 16, 64)]
SHORT_KV_EDGES = ([(2, 3, 16, sk, 96) for sk in (1, 15, 17, 63, 64)]
                  + [(2, 3, sq, 64, 96) for sq in (1, 17, 64)]
                  + [(2, 3, 16, 64, 16), (2, 3, 16, 64, 128),
                     (2, 3, 64, 64, 128), (2, 3, 17, 15, 16),
                     (512, 8, 16, 64, 96), (256, 8, 64, 64, 128)])


def _check_short_kv(cuda, B, H, Sq, Sk, D, views, seed):
    """The short_kv route against the plain version, one launch counted on
    it; then the forced mma_sync route on the same inputs."""
    q, k, v = _bf16_inputs(cuda, B, H, Sq, Sk, D, views, seed)
    assert A._route(q, k, v) == "short_kv"
    before = dict(A.route_launches)
    got = A.fused_attention(q, k, v)
    want = A.attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in A.route_launches.items()} == {
        "wgmma": 0, "short_kv": 1, "mma_sync": 0, "fp32": 0}
    assert got.shape == (B, H, Sq, D) and got.transpose(1, 2).is_contiguous()
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= ATT_TOL["bf16"]
    old = A._launch(q, k, v, route="mma_sync")
    torch.cuda.synchronize()
    assert A.route_launches["mma_sync"] == before["mma_sync"] + 1
    assert A.route_launches["short_kv"] == before["short_kv"] + 1
    assert _rel_err(old, want) <= ATT_TOL["bf16"]


@pytest.mark.parametrize("views", [False, True],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("B,H,Sq,Sk", SGA_SHAPES)
def test_attention_short_kv_route_matches_plain(cuda, views, B, H, Sq, Sk):
    _check_short_kv(cuda, B, H, Sq, Sk, 96, views, seed=30)


@pytest.mark.parametrize("views", [False, True],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("B,H,Sq,Sk,D", SHORT_KV_EDGES)
def test_attention_short_kv_route_edges(cuda, views, B, H, Sq, Sk, D):
    _check_short_kv(cuda, B, H, Sq, Sk, D, views, seed=Sq * 131 + Sk + D)


def test_attention_short_kv_entry_refuses_what_it_does_not_take(cuda):
    """The C entry point refuses a geometry past its kernel (65 keys, D=72,
    fp32) with a CUDA error code, launching nothing."""
    fn = kernel_build.function("attention", A._SYMBOLS["short_kv"],
                               A._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    for Sq, Sk, D, dtype in ((16, 65, 96, 1), (65, 16, 96, 1),
                             (16, 16, 72, 1), (16, 16, 96, 0)):
        q, k, v = _bf16_inputs(cuda, 2, 3, Sq, Sk, D, False, seed=31)
        out = torch.empty(2, Sq, 3, D, device=cuda, dtype=torch.bfloat16)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    2, 3, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], dtype, stream)
        assert status != 0, (Sq, Sk, D, dtype)


# kernel 1's backward (csrc/attention_bwd.cu) where the forward takes the
# wgmma route: the ViT and RoBERTa shapes at H=12 and a tp=2 rank's H=6,
# and the edges of the route's range. It is held against the plain VJP (the
# forced "plain" route) on the same inputs, ATT_TOL["bf16"] of max|ref| for
# each of dq, dk and dv: the kernel rounds dS to a hi and a lo bf16 part
# where the plain VJP keeps it fp32, and sums in another order.
BWD_SHAPES = [(2, 12, 197, 197), (2, 12, 213, 213), (2, 6, 197, 197),
              (2, 6, 213, 213)]
BWD_EDGES = [(1, 2, sq, sk) for sq in (64, 65, 128, 256)
             for sk in (64, 65, 128, 256)] + [(2, 3, 197, 64)]


def _grad_out(cuda, B, H, Sq, main_path, seed):
    """The output's gradient: as the main path hands it back (the
    [B, H, Sq, D] view of a contiguous [B, Sq, H, D]), or contiguous."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if main_path:
        return torch.randn(B, Sq, H, 64, device=cuda, generator=g) \
            .to(torch.bfloat16).transpose(1, 2)
    return torch.randn(B, H, Sq, 64, device=cuda, generator=g) \
        .to(torch.bfloat16)


def _bwd_counts():
    return dict(A.bwd_route_launches), A.bwd_grad_copies


def _check_backward(q, k, v, go, copies=0):
    """The kernel against the plain VJP; exact route counters. Without
    statistics the backward has the forward kernel compute them (counted);
    given the forward's, it returns the same gradients to the bit."""
    (routes, copied) = _bwd_counts()
    recomputed = A.bwd_stats_recomputed
    got = A.attention_backward(q, k, v, go)
    torch.cuda.synchronize()
    assert _bwd_counts() == ({"wgmma": routes["wgmma"] + 1,
                              "plain": routes["plain"]}, copied + copies)
    assert A.bwd_stats_recomputed == recomputed + 1
    _, stats = A._launch(q, k, v, stats=True)
    for a, b in zip(A.attention_backward(q, k, v, go, stats=stats), got):
        assert torch.equal(a, b)
    assert A.bwd_stats_recomputed == recomputed + 1
    want = A.attention_backward(q, k, v, go, route="plain")
    torch.cuda.synchronize()
    assert A.bwd_route_launches["plain"] == routes["plain"] + 1
    for name, a, b, x in zip("qkv", got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.bfloat16, name
        assert a.transpose(1, 2).is_contiguous(), name
        assert torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= ATT_TOL["bf16"], name
    return got, want


@pytest.mark.parametrize("main_path", [True, False],
                         ids=["grad_main_path", "grad_contiguous"])
@pytest.mark.parametrize("views", [False, True],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("B,H,Sq,Sk", BWD_SHAPES)
def test_attention_backward_kernel_matches_plain_vjp(cuda, views, main_path,
                                                     B, H, Sq, Sk):
    q, k, v = _bf16_inputs(cuda, B, H, Sq, Sk, 64, views, seed=20)
    assert A._bwd_route(q, k, v) == "wgmma"
    _check_backward(q, k, v, _grad_out(cuda, B, H, Sq, main_path, seed=21))


@pytest.mark.parametrize("B,H,Sq,Sk", BWD_EDGES)
def test_attention_backward_kernel_edges(cuda, B, H, Sq, Sk):
    q, k, v = _bf16_inputs(cuda, B, H, Sq, Sk, 64, True, seed=Sq + Sk)
    _check_backward(q, k, v, _grad_out(cuda, B, H, Sq, True, seed=Sq * Sk))


@pytest.mark.parametrize("B,H,S", [(128, 12, 213), (1, 2, 197)],
                         ids=["wraps_the_grid", "most_sms_idle"])
def test_attention_backward_kernel_head_counts(cuda, B, H, S):
    """1536 heads wrap the persistent grid (one block per SM) several
    times, through both slots of its ring; 2 heads leave all but two SMs
    idle, each block with one head and no next one to load."""
    q, k, v = _bf16_inputs(cuda, B, H, S, S, 64, True, seed=B + H)
    _check_backward(q, k, v, _grad_out(cuda, B, H, S, True, seed=S))


def _lse(stats):
    """Each row's log-sum-exp of the scaled scores (natural log) from its
    statistics (m, l): (m + log2 l) ln 2."""
    return (stats[..., 0] + torch.log2(stats[..., 1])) * math.log(2.0)


@pytest.mark.parametrize("B,H,Sq,Sk", TMA_SHAPES)
def test_attention_forward_writes_row_statistics(cuda, B, H, Sq, Sk):
    """The wgmma route's forward with statistics: the same output to the
    bit, and each row's (m, l) against the plain ones, as the log-sum-exp
    they give."""
    q, k, v = _bf16_inputs(cuda, B, H, Sq, Sk, 64, True, seed=Sq * 3 + Sk)
    before = A.stats_launches
    out, stats = A._launch(q, k, v, stats=True)
    torch.cuda.synchronize()
    assert A.stats_launches == before + 1
    assert torch.equal(out, A._launch(q, k, v))
    assert A.stats_launches == before + 1
    assert stats.shape == (B, H, Sq, 2) and stats.dtype == torch.float32
    want = _lse(A.attention_stats_reference(q, k))
    err = float((_lse(stats) - want).abs().max())
    assert err <= LSE_TOL * max(1.0, float(want.abs().max())), err
    with pytest.raises(ValueError, match="only the wgmma route"):
        A._launch(q, k, v, route="mma_sync", stats=True)


def test_serving_forwards_write_no_statistics(cuda):
    """Statistics only where autograd will run the backward: not under
    no_grad or inference_mode, not without an input that needs the
    gradient, not off the wgmma route."""
    q, k, v = (t.clone().requires_grad_() for t in
               _bf16_inputs(cuda, 2, 12, 197, 197, 64, False, seed=40))
    before = A.stats_launches
    with torch.no_grad():
        A.fused_attention(q, k, v)
    with torch.inference_mode():
        A.fused_attention(q, k, v)
    A.fused_attention(*(t.detach() for t in (q, k, v)))
    sga = [t.requires_grad_() for t in
           _bf16_inputs(cuda, 2, 8, 16, 64, 96, False, seed=41)]
    A.fused_attention(*sga)
    torch.cuda.synchronize()
    assert A.stats_launches == before
    A.fused_attention(q, k, v)
    assert A.stats_launches == before + 1


def test_attention_backward_through_autograd(cuda):
    """The main path: the head views of [B, S, H*D] projections through
    ``fused_attention`` and its heads merged back, then ``backward()``: one
    kernel backward, no plain VJP, no copy of the gradient; the
    projections' gradients against autograd of the plain version."""
    B, H, S = 2, 12, 213
    g = torch.Generator(device=cuda).manual_seed(22)
    proj = [torch.randn(B, S, H * 64, device=cuda, generator=g)
            .to(torch.bfloat16) for _ in range(3)]
    w = torch.randn(B, S, H * 64, device=cuda, generator=g).to(torch.bfloat16)

    def grads(fn):
        leaves = [p.clone().requires_grad_() for p in proj]
        heads = [x.reshape(B, S, H, 64).transpose(1, 2) for x in leaves]
        out = fn(*heads).transpose(1, 2).reshape(B, S, H * 64)
        (out.float() * w.float()).sum().backward()
        return [x.grad for x in leaves]

    before = _bwd_counts()
    stats, recomputed = A.stats_launches, A.bwd_stats_recomputed
    got = grads(A.fused_attention)
    torch.cuda.synchronize()
    assert _bwd_counts() == ({"wgmma": before[0]["wgmma"] + 1,
                              "plain": before[0]["plain"]}, before[1])
    # the forward wrote the statistics and the backward consumed them
    assert A.stats_launches == stats + 1
    assert A.bwd_stats_recomputed == recomputed
    want = grads(A.attention_reference)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= ATT_TOL["bf16"]


def test_attention_backward_zero_grad_and_saturated_rows(cuda):
    """A zero gradient gives zeros; rows whose softmax saturates (one key
    takes all the weight) match the plain VJP and stay finite."""
    q, k, v = _bf16_inputs(cuda, 2, 12, 197, 197, 64, True, seed=23)
    zero = torch.zeros(2, 197, 12, 64, device=cuda,
                       dtype=torch.bfloat16).transpose(1, 2)
    for t in A.attention_backward(q, k, v, zero):
        assert not t.any()
    # each query row a multiple of one key: that key takes all the weight
    hot = (k.float() * 16).to(torch.bfloat16)
    p = torch.softmax(hot.float() @ k.float().transpose(-1, -2) / 8, -1)
    assert float(p.max(-1).values.min()) > 0.999
    _check_backward(hot, k, v, _grad_out(cuda, 2, 12, 197, True, seed=24))


def test_attention_backward_copies_an_unreadable_grad(cuda):
    """A gradient a tensor map cannot read (a broadcast one) is copied once,
    and the copy counted."""
    q, k, v = _bf16_inputs(cuda, 2, 6, 197, 197, 64, True, seed=25)
    ones = torch.ones((), device=cuda, dtype=torch.bfloat16) \
        .expand(2, 6, 197, 64)
    _check_backward(q, k, v, ones, copies=1)


def test_attention_backward_other_geometries_take_the_plain_vjp(cuda):
    """The SGA (D=96) and fp32 take the plain VJP, through autograd too,
    and it is the plain version's own backward."""
    sga = _bf16_inputs(cuda, 2, 8, 16, 64, 96, True, seed=26)
    fp32 = [t.float() for t in
            _bf16_inputs(cuda, 2, 4, 197, 197, 64, False, seed=27)]
    for q, k, v in (sga, fp32):
        assert A._bwd_route(q, k, v) == "plain"
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _bwd_counts()
        out = A.fused_attention(*leaves)
        go = torch.randn_like(out)
        got = torch.autograd.grad(out, leaves, go)
        torch.cuda.synchronize()
        assert _bwd_counts() == ({"wgmma": before[0]["wgmma"],
                                  "plain": before[0]["plain"] + 1},
                                 before[1])
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(A.attention_reference(*ref), ref, go)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_attention_backward_refuses_what_it_does_not_take(cuda):
    """A forced kernel route on the SGA's geometry, a gradient of another
    shape, and a call the kernel's C entry refuses (D=96, past the
    wrapper's routing) all raise: there is no fallback."""
    q, k, v = _bf16_inputs(cuda, 2, 8, 16, 64, 96, True, seed=28)
    go = torch.zeros_like(q)
    with pytest.raises(ValueError):
        A.attention_backward(q, k, v, go, route="wgmma")
    stats = torch.ones(2, 8, 16, 2, device=cuda)
    with pytest.raises(RuntimeError, match="attention_backward_tma"):
        A._launch_bwd(q, k, v, go, stats)
    q, k, v = _bf16_inputs(cuda, 2, 6, 197, 197, 64, True, seed=29)
    stats = torch.ones(2, 6, 197, 2, device=cuda)
    with pytest.raises(ValueError):
        A._launch_bwd(q, k, v, torch.zeros(2, 6, 196, 64, device=cuda,
                                           dtype=torch.bfloat16), stats)
    go = torch.zeros_like(q)
    for bad in (stats[:, :, :196], stats.to(torch.bfloat16), stats[..., 0],
                stats.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="stats must be"):
            A._launch_bwd(q, k, v, go, bad)


@pytest.mark.parametrize("dtype,name", DTYPES)
@pytest.mark.parametrize("H,Cin,width,stride,ds", [
    (64, 64, 64, 1, True),      # stage 0 block 0
    (64, 256, 64, 1, False),    # stage 0 blocks 1-2
    (64, 256, 128, 2, True),    # stage 1 block 0: stride 2 + downsample
    (32, 512, 128, 1, False),   # stage 1 blocks 1-3
    (20, 256, 64, 1, False),    # partial output tiles
    (18, 256, 128, 2, True),    # partial tiles at stride 2
    (12, 64, 64, 1, True),      # one partial 8x16 tile per image
    (40, 256, 128, 2, True),    # 20x20 output: partial 4x16 tiles
    (9, 64, 64, 1, True),       # the last tile row holds the last image row
    (16, 256, 64, 1, False),    # a whole number of 8x16 tiles
    (32, 256, 128, 2, True),    # a whole number of 4x16 tiles at stride 2
    (18, 128, 64, 2, True),     # width 64 at stride 2
    (24, 128, 128, 1, True),    # width 128 at stride 1 with downsample
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


@pytest.mark.parametrize("H,Cin,width,stride,ds", [
    (64, 256, 64, 1, False),
    (64, 256, 128, 2, True),
    (9, 64, 64, 1, True),
])
def test_bottleneck_kernel_one_image(cuda, H, Cin, width, stride, ds):
    """B=1: one image's tiles, fewer than the card's SMs at small H."""
    block = Bottleneck(Cin, width, stride, ds)
    init_weights(block, torch.Generator().manual_seed(8))
    block = block.to(cuda, torch.bfloat16).eval()
    x = torch.randn(1, H, H, Cin, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(9))
    x = x.to(torch.bfloat16)
    ops = block.fused_operands(torch.bfloat16)
    with torch.inference_mode():
        got = K.fused_bottleneck(x, *ops, stride=stride)
        want = K.bottleneck_reference(x, *ops, stride=stride)
    assert got.shape == (1, H // stride, H // stride, 4 * width)
    assert _rel_err(got, want) <= BLOCK_TOL["bf16"]


@pytest.mark.parametrize("dtype,name", DTYPES)
@pytest.mark.parametrize("stride,ds,Cin", [(1, False, 384), (1, True, 128),
                                           (2, True, 128)])
def test_bottleneck_kernel_last_pass_of_128_columns(cuda, dtype, name,
                                                    stride, ds, Cin):
    """Cout = 384: two passes of the bf16 kernel's conv3, the second 128
    columns wide (half a pass per consumer group)."""
    g = torch.Generator(device=cuda).manual_seed(10)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=cuda, generator=g))

    Cw, Cout, H = 64, 384, 20
    x = rand(2, H, H, Cin).to(dtype)
    ws = [rand(Cin, Cw, scale=Cin ** -0.5), rand(Cw), rand(9 * Cw, Cw,
          scale=(9 * Cw) ** -0.5), rand(Cw), rand(Cw, Cout, scale=Cw ** -0.5),
          rand(Cout)]
    ws += [rand(Cin, Cout, scale=Cin ** -0.5), rand(Cout)] if ds else [None,
                                                                      None]
    ops = [None if t is None else (t.contiguous() if t.dim() == 1 else
                                   t.to(dtype).contiguous()) for t in ws]
    with torch.inference_mode():
        got = K.fused_bottleneck(x, *ops, stride=stride)
        want = K.bottleneck_reference(x, *ops, stride=stride)
    assert got.shape == (2, H // stride, H // stride, Cout)
    assert _rel_err(got, want) <= BLOCK_TOL[name]


@pytest.mark.parametrize("dtype,name", DTYPES)
def test_bottleneck_packed_operands_match_plain_ones(cuda, dtype, name):
    """The module's operands, packed once, give the kernel the same result
    as the operands folded and packed anew on the call."""
    block = Bottleneck(256, 128, 2, True)
    init_weights(block, torch.Generator().manual_seed(6))
    block = block.to(cuda, dtype).eval()
    x = torch.randn(3, 16, 16, 256, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    x = x.to(dtype)
    with torch.inference_mode():
        packed = block.forward_fused(x)
        fresh = K.fused_bottleneck(x, *block.fused_operands(dtype), stride=2)
    torch.testing.assert_close(packed, fresh, rtol=0, atol=0)


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
