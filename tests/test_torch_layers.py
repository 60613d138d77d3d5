"""Port's fusion ops vs the JAX package's ``ops/layers.py``.

SGA stack, multi-head attention (with and without a mask), attention
pooler, channel projection and ``log_softmax_nll`` at hidden 32, heads 4.
JAX params reach the port through the weight bridge and a strict load;
inputs are numpy from a seed. fp32, rtol/atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu import ops as jops
from t5_resnet_vqa_torch import ops
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.utils import weights as W

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
JCFG = jops.AttentionConfig(hidden_size=32, num_heads=4, ff_size=32)
PCFG = ops.AttentionConfig(hidden_size=32, num_heads=4, ff_size=32)


def _np_params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _inputs(seed=0, sx=16, sy=64, hidden=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, sx, hidden), dtype=np.float32),
            rng.standard_normal((2, sy, hidden), dtype=np.float32))


@pytest.mark.parametrize("num_blocks", [1, 3])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_sga_stack_matches_jax(num_blocks, use_kernel):
    text, vision = _inputs()
    jstack = jops.SGAStack(num_blocks=num_blocks, config=JCFG)
    params = _np_params(jstack.init(jax.random.PRNGKey(0), text,
                                    vision)["params"])
    want = np.asarray(jstack.apply({"params": params}, text, vision))

    sd = {}
    W.export_sga_stack(sd, params, num_blocks, prefix="stack")
    stack = ops.SGAStack(num_blocks, PCFG, use_kernel=use_kernel)
    stack.load_state_dict(_strip(sd, "stack."), strict=True)
    before = A.launches
    with torch.no_grad():
        got = stack.eval()(torch.from_numpy(text), torch.from_numpy(vision))
    assert A.launches == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_multi_head_attention_with_mask_matches_jax():
    x, y = _inputs(seed=1, sx=10, sy=12)
    mask = np.random.default_rng(2).random((2, 1, 1, 12)) < 0.25
    jmha = jops.MultiHeadAttention(JCFG)
    params = _np_params(jmha.init(jax.random.PRNGKey(1), y, y, x)["params"])
    want = np.asarray(jmha.apply({"params": params}, y, y, x, mask))

    sd = {}
    W.export_mhatt(sd, params, "m")
    mha = ops.MultiHeadAttention(PCFG, use_kernel=True)
    mha.load_state_dict(_strip(sd, "m."), strict=True)
    with torch.no_grad():
        got = mha.eval()(torch.from_numpy(y), torch.from_numpy(y),
                         torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_attention_pooler_matches_jax():
    x, _ = _inputs(seed=3)
    jpool = jops.AttentionPooler(32)
    params = _np_params(jpool.init(jax.random.PRNGKey(2), x)["params"])
    want = np.asarray(jpool.apply({"params": params}, x))

    sd = {}
    W.export_attention_pooler(sd, params, prefix="p")
    pool = ops.AttentionPooler(32)
    pool.load_state_dict(_strip(sd, "p."), strict=True)
    with torch.no_grad():
        got = pool(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_channel_projection_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 16), dtype=np.float32)     # NHWC
    jproj = jops.ChannelProjection(32)
    params = _np_params(jproj.init(jax.random.PRNGKey(3), x)["params"])
    want = np.asarray(jproj.apply({"params": params}, x))

    sd = {}
    W.export_conv_as_conv_transpose2d(sd, params["conv"], "")
    proj = ops.ChannelProjection(16, 32)
    proj.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = proj(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("temperature", [1.0, 1.5])
@pytest.mark.parametrize("with_labels", [False, True])
def test_log_softmax_nll_matches_jax(temperature, with_labels):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 19), dtype=np.float32) * 3
    labels = rng.integers(0, 19, 4).astype(np.int32) if with_labels else None
    jlp, jloss = jops.log_softmax_nll(logits, labels, temperature)
    lp, loss = ops.log_softmax_nll(
        torch.from_numpy(logits),
        None if labels is None else torch.from_numpy(labels), temperature)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **TOL)
    if with_labels:
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    else:
        assert loss is None and jloss is None


def test_dropout_is_off_in_eval_and_routes_plain_in_train():
    """Train mode keeps the attention dropout (plain path), eval mode drops
    it; the kernel route is taken only without mask and without dropout."""
    x, y = _inputs(seed=6)
    stack = ops.SGAStack(1, PCFG, use_kernel=True)
    text, vision = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        a = stack.eval()(text, vision)
        b = stack.eval()(text, vision)
        torch.manual_seed(0)
        c = stack.train()(text, vision)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
