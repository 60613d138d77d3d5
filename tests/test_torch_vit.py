"""Port's ViT tower vs the JAX package's ``models/vit.py``, and vs the HF
``ViTModel`` that the reference uses as its vision tower.

``ViTConfig.tiny()`` (hidden 32, 2 layers, 4 heads, 8x8 patches of 32^2
images). JAX params reach the port through the weight bridge
(``export_vit``) and a strict load; the JAX side runs with ``use_pallas``,
which is its plain jnp path on the CPU, as the port's kernel route is its
plain version here. HF weights load by their own keys. fp32, rtol/atol 1e-5
for hidden states, pooled output and attention maps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core import constants as jconstants
from t5_resnet_vqa_tpu.data.preprocessing import finalize_image as jax_finalize
from t5_resnet_vqa_tpu.models import vit as jvit
from t5_resnet_vqa_tpu.models.image_input import (
    finalize_image_input as jax_finalize_input,
)
from t5_resnet_vqa_torch.data.preprocessing import finalize_image
from t5_resnet_vqa_torch.models import finalize_image_input
from t5_resnet_vqa_torch.models import vit as pvit
from t5_resnet_vqa_torch.utils import weights as W

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
NORMALIZE = (jconstants.VIT_IMAGE_MEAN, jconstants.VIT_IMAGE_STD)


def _port_config(jcfg):
    return pvit.ViTConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(pvit.ViTConfig)})


def _pair(seed=0, use_kernel=True, B=3):
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), use_pallas=True)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, jcfg.image_size, jcfg.image_size, 3)
                            ).astype(np.float32)
    jmodel = jvit.ViTModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), x)["params"]
    # random CLS token and position embeddings (init gives zeros)
    params = dict(params)
    params["cls_token"] = rng.normal(0, 0.5, params["cls_token"].shape)
    params["position_embeddings"] = rng.normal(
        0, 0.5, params["position_embeddings"].shape)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    sd = {}
    W.export_vit(sd, params, jcfg.num_layers)
    model = pvit.ViTModel(_port_config(jcfg), use_kernel=use_kernel)
    model.load_state_dict(sd, strict=True)
    return jmodel, params, model.eval(), x


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_vit_matches_jax(use_kernel, seed):
    jmodel, params, model, x = _pair(seed, use_kernel)
    want_h, want_p = jmodel.apply({"params": params}, x)
    with torch.no_grad():
        got_h, got_p = model(torch.from_numpy(x))
    assert got_h.shape == (3, 17, 32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_vit_attention_maps_match_jax():
    jmodel, params, model, x = _pair(2)
    want_h, want_p, want_att = jmodel.apply({"params": params}, x,
                                            return_attentions=True)
    with torch.no_grad():
        got_h, got_p, got_att = model(torch.from_numpy(x),
                                      return_attentions=True)
    assert got_att.shape == (2, 3, 4, 17, 17)
    assert got_att.dtype == torch.float32
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_att.sum(-1).numpy(), 1.0, atol=1e-5)


def test_vit_matches_hf(monkeypatch):
    """HF ``ViTModel`` built offline from a config (no pretrained files),
    random weights from numpy, loaded into the port strictly."""
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = pvit.ViTConfig.tiny()
    hf = transformers.ViTModel(transformers.ViTConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.mlp_dim,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=cfg.layer_norm_eps,
        attn_implementation="eager"), add_pooling_layer=True).eval()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape, dtype=np.float32) * 0.2))
    model = pvit.ViTModel(cfg, use_kernel=True)
    model.load_state_dict(hf.state_dict(), strict=True)
    x = rng.standard_normal((2, 3, cfg.image_size, cfg.image_size),
                            dtype=np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x), output_attentions=True)
        got_h, got_p, got_att = model.eval()(
            torch.from_numpy(x.transpose(0, 2, 3, 1)), return_attentions=True)
    np.testing.assert_allclose(got_h.numpy(),
                               want.last_hidden_state.numpy(), **TOL)
    np.testing.assert_allclose(got_p.numpy(), want.pooler_output.numpy(),
                               **TOL)
    np.testing.assert_allclose(
        got_att.numpy(), np.stack([a.numpy() for a in want.attentions]),
        **TOL)


def test_vit_base_geometry():
    cfg = pvit.ViTConfig.vit_base()
    assert (cfg.num_patches + 1, cfg.num_heads, cfg.head_dim) == (197, 12, 64)
    assert cfg == _port_config(jvit.ViTConfig.vit_base())


@pytest.mark.parametrize("normalize", [None, NORMALIZE])
def test_image_finalization_matches_jax(normalize):
    """The uint8 wire's device finalization and the host's, against the
    JAX package's: the same fp32 values to the bit."""
    img = np.random.default_rng(4).integers(0, 256, (2, 8, 8, 3),
                                            dtype=np.uint8)
    want = np.asarray(jax_finalize_input(jnp.asarray(img), normalize))
    got = finalize_image_input(torch.from_numpy(img), normalize).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(finalize_image(img[0], normalize),
                                  jax_finalize(img[0], normalize))
    np.testing.assert_array_equal(finalize_image(img[0], normalize), got[0])
    x = torch.rand(1, 4, 4, 3)
    assert finalize_image_input(x, normalize) is x
