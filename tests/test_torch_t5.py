"""Port's T5 encoder vs the JAX package's ``models/t5.py``, and vs the HF
``T5EncoderModel`` that the reference uses as its text tower.

``T5Config.tiny()`` with a padded attention mask; JAX params reach the port
through the weight bridge and a strict load, HF weights by their own keys.
fp32, rtol/atol 1e-5. The relative-position buckets must be identical
integers. On the CPU the encoder's CUDA-graph replay never engages: every
forward is the eager one, to the bit, and is counted as such
(``tests/test_torch_text_graph_gpu.py`` holds the replay on a card).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models import t5 as jt5
from t5_resnet_vqa_torch.models import t5 as pt5
from t5_resnet_vqa_torch.utils import profiling
from t5_resnet_vqa_torch.utils import weights as W

torch.set_num_threads(2)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
def test_relative_position_bucket_matches_jax(bidirectional, num_buckets,
                                              max_distance):
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional, num_buckets,
        max_distance))
    got = pt5.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                       num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def _encoder_pair(num_layers=2, seed=0):
    jcfg = jt5.T5Config.tiny()
    jcfg = jt5.T5Config(**{**jcfg.__dict__, "num_layers": num_layers})
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, jcfg.vocab_size, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    ids[mask == 0] = 0
    jenc = jt5.T5Encoder(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jenc.init(jax.random.PRNGKey(seed), ids, mask)["params"])
    sd = {}
    W.export_t5_encoder(sd, params, num_layers, prefix="enc",
                        shared_key="enc.embed_tokens.weight")
    pcfg = pt5.T5Config(**{k: getattr(jcfg, k) for k in
                           pt5.T5Config.__dataclass_fields__})
    enc = pt5.T5Encoder(pcfg)
    enc.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    return jenc, params, enc.eval(), ids, mask


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_encoder_matches_jax_with_padding(num_layers):
    jenc, params, enc, ids, mask = _encoder_pair(num_layers)
    want = np.asarray(jenc.apply({"params": params}, ids, mask))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_encoder_without_mask_matches_jax():
    jenc, params, enc, ids, _ = _encoder_pair(seed=1)
    want = np.asarray(jenc.apply({"params": params}, ids))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rmsnorm_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    norm = jt5.RMSNorm()
    params = norm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(norm.apply(params, x))
    got = pt5.RMSNorm(32)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_encoder_matches_hf_t5_encoder(monkeypatch):
    """HF ``T5EncoderModel`` built offline from a config (no pretrained
    files), random weights from numpy, loaded into the port strictly."""
    monkeypatch.setenv("USE_TF", "0")       # the text tower needs no TF
    transformers = pytest.importorskip("transformers")
    cfg = pt5.T5Config.tiny()
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
        d_ff=cfg.d_ff, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance,
        dropout_rate=cfg.dropout_rate,
        layer_norm_epsilon=cfg.layer_norm_epsilon,
        feed_forward_proj="relu")).eval()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape, dtype=np.float32) * 0.3))
    enc = pt5.T5Encoder(cfg)
    enc.load_state_dict({k[len("encoder."):]: v
                         for k, v in hf.state_dict().items()
                         if k.startswith("encoder.")}, strict=True)
    _, _, _, ids, mask = _encoder_pair(seed=4)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        want = hf(input_ids=ids_t, attention_mask=mask_t.long())
        got = enc.eval()(ids_t, mask_t)
    np.testing.assert_allclose(got.numpy(), want.last_hidden_state.numpy(),
                               rtol=1e-5, atol=1e-5)


# --- the encoder's CUDA-graph replay (``T5Encoder``): on the CPU it never
# engages, and every call runs today's eager forward


def _text_counters():
    got = profiling.counters()
    return tuple(got.get(f"text.{k}", 0)
                 for k in ("forwards", "graph_replays", "graph_captures"))


def _eager_forward(enc, ids, mask):
    """The encoder's forward as the stack computes it, module by module."""
    x = enc.dropout(enc.embed_tokens(ids.long()))
    mask_bias = pt5.attention_mask_bias(mask)
    position_bias = None
    for block in enc.block:
        x, position_bias = block(x, position_bias, mask_bias)
    return enc.dropout(enc.final_layer_norm(x))


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "grad",
                                  "train"])
def test_encoder_on_the_cpu_runs_eagerly_and_counts(mode):
    _, _, enc, ids, mask = _encoder_pair()
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    if mode == "train":
        enc.train()
    grad = {"inference_mode": torch.inference_mode(),
            "no_grad": torch.no_grad()}.get(mode, contextlib.nullcontext())
    before = _text_counters()
    for i in range(3):
        with grad:
            torch.manual_seed(i)        # the same dropout masks in train()
            got = enc(ids, mask)
            torch.manual_seed(i)
            want = _eager_forward(enc, ids, mask)
        assert torch.equal(got, want)
        assert got.requires_grad == (mode in ("grad", "train"))
    forwards, replays, captures = (a - b for a, b in
                                   zip(_text_counters(), before))
    assert (forwards, replays, captures) == (3, 0, 0)
    assert not enc._graphs and not enc._seen


def test_moving_the_encoder_drops_its_graphs():
    _, _, enc, _, _ = _encoder_pair()
    key = ("signature",)
    enc._graphs[key] = object()
    enc._seen.add(key)
    enc.double()
    assert not enc._graphs and not enc._seen
    enc._graphs[key] = object()
    enc.drop_graphs()
    assert not enc._graphs
