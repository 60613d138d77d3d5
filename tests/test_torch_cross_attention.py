"""The port's cross-attention family against the JAX package and HF:
``RobertaEmbeddings``, ``RobertaLayer`` and ``CrossAttentionVitVQAModel``.

* The RoBERTa pieces at ``RobertaConfig.tiny()`` in fp32 against the JAX
  modules (1e-5), on question ids that hold the tokenizer's pad 0 and EOS
  1 (RoBERTa's pad id, so EOS positions stay pinned at 1 in both
  packages), with the attention core on the kernel route (its plain
  version on the CPU) and off; and against ``transformers``' own
  ``RobertaModel`` embeddings and first layer, built offline from a tiny
  config with dropout off (1e-5): the key layout is HF's.
* The model: ``ViTConfig.tiny()`` (32x32 images in 8x8 patches, 17 image
  tokens) x ``RobertaConfig.tiny()``, 2 interleaved layers, 16 question
  tokens (S = 33 in the RoBERTa layers), 19 answers, uint8 images. JAX
  params (a random CLS token and position embeddings) reach the port
  through ``cross_attention_state_dict_from_jax`` and a strict load:
  log-probs and loss within 1e-4 with the kernel routes on and off; the
  key set and values equal ``export_cross_attention_vqa_checkpoint``'s.
  A frozen ViT gets no gradient; a fine-tuned one does.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models.cross_attention_vqa import (
    CrossAttentionVitVQAModel as JaxModel,
)
from t5_resnet_vqa_tpu.models.roberta import RobertaConfig as JaxRobertaConfig
from t5_resnet_vqa_tpu.models.roberta import (
    RobertaEmbeddings as JaxEmbeddings,
)
from t5_resnet_vqa_tpu.models.roberta import RobertaLayer as JaxLayer
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.utils.torch_export import (
    export_cross_attention_vqa_checkpoint,
)
from t5_resnet_vqa_torch.models import (
    CrossAttentionVitVQAModel,
    RobertaConfig,
    RobertaEmbeddings,
    RobertaLayer,
    ViTConfig,
)
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.utils import cross_attention_state_dict_from_jax
from t5_resnet_vqa_torch.utils.weights import (
    export_roberta_embeddings,
    export_roberta_layer,
)

torch.set_num_threads(4)

ANSWERS = 19
B = 3
LAYERS = 2


def question_ids(rng, b=B, vocab=128):
    """T5-tokenized questions: words >= 2, then EOS 1, then pad 0."""
    ids = np.zeros((b, 16), np.int32)
    for i in range(b):
        n = int(rng.integers(4, 15))
        ids[i, :n] = rng.integers(2, vocab, n)
        ids[i, n] = 1
    return ids


def jax_model(fine_tune_vision=False, dropout=0.0):
    return JaxModel(answer_spaces=ANSWERS, vit_config=JaxViTConfig.tiny(),
                    roberta_config=dataclasses.replace(
                        JaxRobertaConfig.tiny(), dropout_rate=dropout),
                    fine_tune_vision=fine_tune_vision)


def port_model(params=None, use_kernels=True, fine_tune_vision=False,
               answers=ANSWERS, dropout=0.0, vit_config=None):
    model = CrossAttentionVitVQAModel(
        answers, vit_config=vit_config or ViTConfig.tiny(),
        roberta_config=dataclasses.replace(RobertaConfig.tiny(),
                                           dropout_rate=dropout),
        fine_tune_vision=fine_tune_vision, use_kernels=use_kernels,
        device="cpu")
    if params is not None:
        model.load_state_dict(cross_attention_state_dict_from_jax(
            params, LAYERS), strict=True)
    return model


def init_params(model, rng, batch):
    """``model.init`` params as numpy, with a random CLS token and position
    embeddings (init gives zeros)."""
    params = jax.tree_util.tree_map(
        np.array, model.init(jax.random.PRNGKey(0), **batch)["params"])
    emb = params["vit_embeddings"]
    for k in ("cls_token", "position_embeddings"):
        emb[k] = rng.normal(0.0, 0.5, emb[k].shape).astype(np.float32)
    return params


def make_batch(rng, b=B, image=32, answers=ANSWERS):
    ids = question_ids(rng, b)
    return dict(question_input_ids=ids,
                question_attention_masks=(ids != 0).astype(np.int32),
                pixel_values=rng.integers(0, 256, (b, image, image, 3),
                                          dtype=np.uint8),
                annotation_ids=rng.integers(0, answers, b).astype(np.int32))


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    batch = make_batch(rng)
    model = jax_model()
    params = init_params(model, rng, batch)
    log_probs, loss = model.apply({"params": params}, **batch)
    return dict(params=params, batch=batch, log_probs=np.asarray(log_probs),
                loss=float(loss))


def _randomized(params, rng, scale=0.3):
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + rng.normal(0.0, scale, np.shape(p))
                   ).astype(np.float32), params)


def test_roberta_embeddings_match_jax():
    rng = np.random.default_rng(1)
    cfg = JaxRobertaConfig.tiny()
    ids = question_ids(rng)
    assert (ids == 0).any() and (ids == 1).any()      # pad and EOS
    jemb = JaxEmbeddings(cfg)
    params = _randomized(jemb.init(jax.random.PRNGKey(1), ids)["params"], rng)
    want = np.asarray(jemb.apply({"params": params}, ids))
    emb = RobertaEmbeddings(RobertaConfig.tiny()).eval()
    state = {}
    export_roberta_embeddings(state, params, "e")
    emb.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = emb(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_roberta_layer_matches_jax(use_kernel):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 33, 32)).astype(np.float32)
    jlayer = JaxLayer(JaxRobertaConfig.tiny())
    params = _randomized(jlayer.init(jax.random.PRNGKey(2), x)["params"],
                         rng, 0.1)
    want = np.asarray(jlayer.apply({"params": params}, x))
    layer = RobertaLayer(RobertaConfig.tiny(), use_kernel).eval()
    state = {}
    export_roberta_layer(state, params, "l")
    layer.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    counts = A.launches
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert A.launches == counts                   # CPU: no kernel launches
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_roberta_pieces_match_hf():
    from transformers import RobertaConfig as HFConfig
    from transformers import RobertaModel

    cfg = RobertaConfig.tiny()
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size,
        layer_norm_eps=cfg.layer_norm_eps, pad_token_id=cfg.pad_token_id,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu")
    torch.manual_seed(3)
    hf = RobertaModel(hf_cfg, add_pooling_layer=False).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    state = hf.state_dict()
    emb = RobertaEmbeddings(cfg).eval()
    emb.load_state_dict({k[len("embeddings."):]: v for k, v in state.items()
                         if k.startswith("embeddings.")}, strict=True)
    layer = RobertaLayer(cfg, use_kernel=True).eval()
    prefix = "encoder.layer.0."
    layer.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                           if k.startswith(prefix)}, strict=True)
    ids = torch.from_numpy(question_ids(np.random.default_rng(4)).astype(
        np.int64))
    with torch.no_grad():
        want_emb = hf.embeddings(input_ids=ids)
        want = hf.encoder.layer[0](want_emb)[0]
        got_emb = emb(ids)
        got = layer(got_emb)
    torch.testing.assert_close(got_emb, want_emb, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_model_matches_jax(jax_run, use_kernels):
    model = port_model(jax_run["params"], use_kernels).eval()
    assert model.roberta_encoder_layers[0].use_kernel is use_kernels
    assert model.vit_encoder_layers[0].attention.attention.use_kernel \
        is use_kernels
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    with torch.inference_mode():
        log_probs, loss = model(**batch)
    np.testing.assert_allclose(log_probs.numpy(), jax_run["log_probs"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=0,
                               atol=1e-4)


def test_state_dict_from_jax_equals_reference_exporter(jax_run):
    ours = cross_attention_state_dict_from_jax(jax_run["params"], LAYERS)
    theirs = export_cross_attention_vqa_checkpoint(jax_run["params"],
                                                   LAYERS)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key], value), key
    keys = set(port_model().state_dict())
    assert keys == set(theirs)
    for key in ("roberta_embeddings.word_embeddings.weight",
                "roberta_encoder_layers.1.attention.self.query.weight",
                "roberta_encoder_layers.0.attention.output.LayerNorm.bias",
                "roberta_encoder_layers.0.output.LayerNorm.weight",
                "vit_embeddings.patch_embeddings.projection.weight",
                "vit_encoder_layers.1.attention.attention.key.bias",
                "layer_norm.weight", "attention_pooler.attention.0.weight",
                "classification_layer.bias"):
        assert key in keys, key


@pytest.mark.parametrize("fine_tune_vision", [False, True])
def test_frozen_vit_gets_no_gradient(jax_run, fine_tune_vision):
    model = port_model(jax_run["params"],
                       fine_tune_vision=fine_tune_vision).train()
    assert model.frozen_modules() == (
        () if fine_tune_vision else ("vit_embeddings", "vit_layer_0",
                                     "vit_layer_1"))
    assert not hasattr(model, "compute_vision_features")
    batch = {k: torch.from_numpy(v) for k, v in jax_run["batch"].items()}
    model(**batch)[1].backward()
    for name, p in model.named_parameters():
        vit = name.startswith(("vit_embeddings.", "vit_encoder_layers."))
        if vit and not fine_tune_vision:
            assert p.grad is None, name
        elif not name.endswith("key.bias"):    # zero in exact arithmetic
            assert p.grad is not None and p.grad.abs().max() > 0, name
