"""Port's attention kernel wrapper vs the JAX package's attention.

``attention_reference`` (the plain version of ``csrc/attention.cu``) is held
against the Pallas kernel body run through the Pallas interpreter and
against the JAX ``dot_product_attention``, on the same numpy inputs, fp32,
rtol/atol 2e-5. On CPU tensors the wrapper must take the plain version and
count no launch. The kernel itself runs only on a CUDA card:
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold it against
the plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.ops import dot_product_attention as jax_attention
from t5_resnet_vqa_tpu.ops.pallas import attention as pa
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops.layers import dot_product_attention

torch.set_num_threads(2)

SHAPES = [
    (2, 8, 16, 96),    # SGA text-query geometry
    (1, 8, 64, 96),    # vision tokens
    (2, 4, 20, 24),    # unaligned everything
]


def _pallas_interpret(q, k, v):
    """The TPU kernel body through the Pallas interpreter."""
    from jax.experimental import pallas as pl

    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    sq_p = pa._round_up(Sq, pa._SUBLANE)
    sk_p = pa._round_up(Sk, pa._SUBLANE)
    d_p = pa._round_up(D, pa._LANE)

    def pad(x, s_p):
        return jnp.pad(x, ((0, 0), (0, 0), (0, s_p - x.shape[2]),
                           (0, d_p - D)))

    kernel = functools.partial(pa._attention_kernel, sk_valid=Sk,
                               scale=1.0 / (D ** 0.5))
    out = pl.pallas_call(
        kernel,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, H, sq_p, d_p), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((1, H, sk_p, d_p), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((1, H, sk_p, d_p), lambda i: (i, 0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, H, sq_p, d_p), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, H, sq_p, d_p), q.dtype),
        interpret=True,
    )(pad(q, sq_p), pad(k, sk_p), pad(v, sk_p))
    return np.asarray(out[:, :, :Sq, :D])


def _inputs(shape, sk_extra=5, seed=0):
    B, H, Sq, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, H, Sq + sk_extra, D), dtype=np.float32)
    v = rng.standard_normal((B, H, Sq + sk_extra, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_kernel_body(shape):
    q, k, v = _inputs(shape)
    want = _pallas_interpret(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = A.attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_dot_product_attention(shape):
    q, k, v = _inputs(shape)
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))))
    got = A.attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_masked_attention_matches_jax():
    q, k, v = _inputs((2, 4, 10, 16), sk_extra=3)
    rng = np.random.default_rng(1)
    mask = rng.random((2, 1, 1, 13)) < 0.3
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v)),
                                    jnp.asarray(mask)))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_takes_plain_version_on_cpu(shape):
    q, k, v = map(torch.from_numpy, _inputs(shape))
    before = A.launches
    got = A.fused_attention(q, k, v)
    routed = dot_product_attention(q, k, v, use_kernel=True)
    assert A.launches == before
    want = A.attention_reference(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(routed, want, rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    q = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.fused_attention(q, q, q)


def test_backward_is_the_vjp_of_the_reference():
    q, k, v = (t.requires_grad_() for t in
               map(torch.from_numpy, _inputs((1, 2, 6, 8), sk_extra=2)))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 2, 6, 8), dtype=np.float32))
    want = torch.autograd.grad(A.attention_reference(q, k, v), (q, k, v), g)
    got = A._FusedAttention.backward(
        type("Ctx", (), {"saved_tensors": (q.detach(), k.detach(),
                                           v.detach())})(), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
