"""Port's T5 decoder and ViT-family model vs the JAX package, and the decoder
vs the HF ``T5ForConditionalGeneration`` the reference uses.

``ViTConfig.tiny()`` + a T5 with 2 encoder and 2 decoder layers, d_model
32, vocab 64, inputs from a numpy seed, decoder rows with different
lengths. JAX params reach the port through ``vit_state_dict_from_jax`` (the
layout of ``export_vit_vqa_checkpoint``) and a strict load; the JAX tower
runs with ``use_pallas``, its plain jnp path on the CPU. fp32; log-probs,
loss, vocabulary logits and decoder states within rtol/atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models import t5 as jt5
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.models.vit_vqa import VitVQAModel as JaxModel
from t5_resnet_vqa_torch.models import T5Config, ViTConfig, VitVQAModel
from t5_resnet_vqa_torch.models import t5 as pt5
from t5_resnet_vqa_torch.utils import vit_state_dict_from_jax
from t5_resnet_vqa_torch.utils import weights as W

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ANSWERS = 11
B, SQ, SD = 3, 16, 20
T5_KW = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_decoder_layers=2, num_heads=4)


def make_batch(rng, image_size=32, uint8=False, b=B):
    q_mask = np.ones((b, SQ), np.int32)
    q_mask[1, 9:] = 0
    d_mask = np.zeros((b, SD), np.int32)
    for i, n in enumerate([12, 7, 15, 5, 9, 11][:b]):
        d_mask[i, :n] = 1
    q_ids = rng.integers(2, 64, (b, SQ)).astype(np.int32) * q_mask
    d_ids = rng.integers(2, 64, (b, SD)).astype(np.int32) * d_mask
    shape = (b, image_size, image_size, 3)
    pix = (rng.integers(0, 256, shape, dtype=np.uint8) if uint8 else
           rng.standard_normal(shape).astype(np.float32))
    return dict(question_input_ids=q_ids, question_attention_masks=q_mask,
                decoder_question_input_ids=d_ids,
                decoder_question_attention_masks=d_mask, pixel_values=pix,
                annotation_ids=rng.integers(0, ANSWERS, b).astype(np.int32))


def jax_vit_vqa(vit_cfg=None, t5_kw=T5_KW, seed=0, image_size=32):
    """(JAX model, numpy params): random params with a random CLS token and
    position embeddings (init gives zeros), no dropout."""
    vit_cfg = dataclasses.replace(vit_cfg or JaxViTConfig.tiny(),
                                  use_pallas=True)
    model = JaxModel(answer_spaces=ANSWERS, t5_config=jt5.T5Config(**t5_kw),
                     vit_config=vit_cfg)
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, image_size)
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(seed), **batch)["params"])
    vm = dict(params["vision_model"])
    for k in ("cls_token", "position_embeddings"):
        vm[k] = rng.normal(0.0, 0.5, vm[k].shape).astype(np.float32)
    params = {**params, "vision_model": vm}
    return model, params


def port_vit_vqa(params, vit_cfg=None, t5_kw=T5_KW, **kw):
    vit_cfg = vit_cfg or JaxViTConfig.tiny()
    cfg = ViTConfig(**{f.name: getattr(vit_cfg, f.name)
                       for f in dataclasses.fields(ViTConfig)})
    model = VitVQAModel(ANSWERS, t5_config=T5Config(**t5_kw), vit_config=cfg,
                        device="cpu", **kw)
    model.load_state_dict(vit_state_dict_from_jax(
        params, cfg.num_layers, t5_kw["num_layers"]), strict=True)
    return model.eval()


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    return jax_vit_vqa()


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("uint8", [False, True])
def test_forward_matches_jax(pair, use_kernels, uint8):
    jmodel, params = pair
    batch = make_batch(np.random.default_rng(5), uint8=uint8)
    want_lp, want_loss = jmodel.apply({"params": params}, **batch)
    model = port_vit_vqa(params, use_kernels=use_kernels)
    with torch.no_grad():
        got_lp, got_loss = model(**torch_batch(batch))
    assert got_lp.shape == (B, ANSWERS) and got_lp.dtype == torch.float32
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), **TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


def test_attention_maps_and_cached_features_match_jax(pair):
    jmodel, params = pair
    batch = make_batch(np.random.default_rng(6))
    want_lp, _, want_att = jmodel.apply({"params": params}, **batch,
                                        return_attentions=True)
    model = port_vit_vqa(params)
    tb = torch_batch(batch)
    with torch.no_grad():
        got_lp, _, got_att = model(**tb, return_attentions=True)
        feats = model.compute_vision_features(tb["pixel_values"])
        cached_lp, _ = model(**{k: v for k, v in tb.items()
                                if k != "pixel_values"},
                             vision_features=feats)
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), **TOL)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), **TOL)
    np.testing.assert_allclose(cached_lp.numpy(), got_lp.numpy(), **TOL)
    with pytest.raises(ValueError, match="return_attentions"):
        model(**tb, vision_features=feats, return_attentions=True)


def test_decode_vocab_logits_match_jax(pair):
    jmodel, params = pair
    batch = make_batch(np.random.default_rng(7))
    args = (batch["question_input_ids"], batch["question_attention_masks"],
            batch["pixel_values"])
    fused = jmodel.apply({"params": params}, *args, method="fuse")
    want = jmodel.apply({"params": params},
                        batch["decoder_question_input_ids"],
                        batch["decoder_question_attention_masks"], fused,
                        method="decode_vocab_logits")
    model = port_vit_vqa(params)
    with torch.no_grad():
        got_fused = model.fuse(*(torch.from_numpy(a) for a in args))
        got = model.decode_vocab_logits(
            torch.from_numpy(batch["decoder_question_input_ids"]),
            torch.from_numpy(batch["decoder_question_attention_masks"]),
            got_fused)
    assert got.shape == (B, SD, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got_fused.numpy(), np.asarray(fused), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_vocab_logits_are_fp32_products_of_bf16_operands(pair):
    """In bf16 the head's products are of the bf16-rounded states and table,
    summed into fp32, as ``preferred_element_type=float32`` gives them."""
    _, params = pair
    model = port_vit_vqa(params).to(torch.bfloat16)
    h = torch.randn(2, 5, 32).to(torch.bfloat16)
    got = model.vocab_logits(h)
    assert got.dtype == torch.float32
    hs = (h * 32 ** -0.5).float()
    want = hs @ model.lang_model.shared.weight.float().t()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_tied_table_is_one_parameter(pair):
    _, params = pair
    model = port_vit_vqa(params)
    lm = model.lang_model
    tables = (lm.shared.weight, lm.encoder.embed_tokens.weight,
              lm.decoder.embed_tokens.weight, lm.lm_head.weight)
    assert all(t is lm.shared.weight for t in tables)
    names = [n for n, p in model.named_parameters() if p is lm.shared.weight]
    assert names == ["lang_model.shared.weight"]
    np.testing.assert_array_equal(lm.shared.weight.detach().numpy(),
                                  params["shared"]["embedding"])
    sd = model.state_dict()
    assert sd["lang_model.lm_head.weight"].data_ptr() == \
        sd["lang_model.decoder.embed_tokens.weight"].data_ptr()


@pytest.mark.parametrize("fine_tune_vision", [False, True])
def test_frozen_tower_gets_no_gradient(pair, fine_tune_vision):
    _, params = pair
    model = port_vit_vqa(params, fine_tune_vision=fine_tune_vision).train()
    assert model.frozen_modules() == (() if fine_tune_vision
                                      else ("vision_model",))
    _, loss = model(**torch_batch(make_batch(np.random.default_rng(8))))
    loss.backward()
    vision = [p.grad for p in model.vision_model.parameters()]
    if fine_tune_vision:
        assert all(g is not None for g in vision)
    else:
        assert all(g is None for g in vision)
    assert model.lang_model.shared.weight.grad is not None
    assert model.fusing_layer[0].weight.grad is not None


def _decoder_inputs(seed):
    rng = np.random.default_rng(seed)
    batch = make_batch(rng)
    memory = rng.standard_normal((B, 1, 32)).astype(np.float32)
    return (batch["decoder_question_input_ids"],
            batch["decoder_question_attention_masks"], memory)


def test_decoder_matches_jax():
    cfg = jt5.T5Config(**T5_KW)
    ids, mask, memory = _decoder_inputs(9)
    jdec = jt5.T5Decoder(cfg)
    params = jax.tree_util.tree_map(np.asarray, jdec.init(
        jax.random.PRNGKey(1), ids, memory, mask)["params"])
    want = jdec.apply({"params": params}, ids, memory, mask)
    sd = {}
    W.export_t5_decoder(sd, params, cfg.num_decoder_layers, prefix="",
                        shared_key="embed_tokens.weight")
    sd = {k.lstrip("."): v for k, v in sd.items()}
    dec = pt5.T5Decoder(T5Config(**T5_KW))
    dec.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = dec.eval()(torch.from_numpy(ids), torch.from_numpy(memory),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_mask_bias_matches_jax():
    _, mask, _ = _decoder_inputs(10)
    want = np.asarray(jt5.causal_mask_bias(jnp.asarray(mask)))
    got = pt5.causal_mask_bias(torch.from_numpy(mask))
    assert got.shape == (B, 1, SD, SD) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_decoder_and_lm_head_match_hf(monkeypatch):
    """HF ``T5ForConditionalGeneration`` built offline, random weights from
    numpy, its state dict (four tied table keys) loaded strictly into the
    port's container; decoder states over a 1-token memory and the tied LM
    head's logits (HF scales by d_model**-0.5 before it) agree."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = T5Config(**T5_KW)
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
        d_ff=cfg.d_ff, num_layers=cfg.num_layers,
        num_decoder_layers=cfg.num_decoder_layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance,
        dropout_rate=0.0, layer_norm_epsilon=cfg.layer_norm_epsilon,
        feed_forward_proj="relu", tie_word_embeddings=True)).eval()
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape, dtype=np.float32) * 0.3))
    port = pt5.T5ForConditionalGeneration(cfg)
    port.load_state_dict(hf.state_dict(), strict=True)
    assert port.lm_head.weight is port.shared.weight
    ids, mask, memory = _decoder_inputs(12)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    mem_t = torch.from_numpy(memory)
    with torch.no_grad():
        want = hf(encoder_outputs=(mem_t,), decoder_input_ids=ids_t,
                  decoder_attention_mask=mask_t.long(),
                  output_hidden_states=True)
        got = port.eval().decoder(ids_t, mem_t, mask_t)
        logits = got * cfg.d_model ** -0.5 @ port.shared.weight.t()
    np.testing.assert_allclose(got.numpy(),
                               want.decoder_hidden_states[-1].numpy(), **TOL)
    np.testing.assert_allclose(logits.numpy(), want.logits.numpy(), **TOL)
