"""The port's slice as a whole vs the JAX package: ``ResnetVQAModel``.

ResNet-50 + T5 (d_model 32, 2 layers) + SGA (hidden 32, 4 heads, 2 blocks)
on 64x64 uint8 images. JAX params (with randomised BatchNorms, so the fold
matters) reach the port through ``state_dict_from_jax`` and a strict load.
The port runs with its kernel routes on (stages 0-1 through the fused
bottleneck, the SGA cores through fused attention: their plain versions on
the CPU), and with both off. Log-probs and loss agree with
JAX ``model.apply`` to atol 1e-4 in fp32.
"""

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxModel
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.utils.torch_export import export_resnet_vqa_checkpoint
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.utils import state_dict_from_jax

torch.set_num_threads(4)

ANSWERS = 19
T5_KW = dict(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_decoder_layers=2, num_heads=4)
SGA_KW = dict(hidden_size=32, num_heads=4, ff_size=32)
BLOCKS = 2


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    model = JaxModel(answer_spaces=ANSWERS, vision_model_name="resnet50",
                     t5_config=JaxT5Config(**T5_KW),
                     num_attention_blocks=BLOCKS,
                     sga_config=JaxAttentionConfig(**SGA_KW))
    ids = rng.integers(2, 256, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 7:] = 0
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    labels = np.array([3, 11], np.int32)
    params = model.init(jax.random.PRNGKey(0), question_input_ids=ids,
                        question_attention_masks=mask,
                        image_tensors=images)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    # non-trivial frozen BatchNorms: the kernels fold them into the weights
    for block in params["vision_model"].values():
        for name, sub in block.items():
            if "bn" in name:
                n = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
                sub["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
    log_probs, loss, feats = model.apply(
        {"params": params}, question_input_ids=ids,
        question_attention_masks=mask, image_tensors=images,
        annotation_ids=labels, return_features=True)
    return dict(params=params, ids=ids, mask=mask, images=images,
                labels=labels, log_probs=np.asarray(log_probs),
                loss=float(loss), features=np.asarray(feats["features"]))


def _port_model(jr, use_kernels):
    model = ResnetVQAModel(ANSWERS, vision_model_name="resnet50",
                           t5_config=T5Config(**T5_KW),
                           num_attention_blocks=BLOCKS,
                           sga_config=AttentionConfig(**SGA_KW),
                           use_kernels=use_kernels, device="cpu")
    model.load_state_dict(
        state_dict_from_jax(jr["params"], "resnet50", BLOCKS,
                            T5_KW["num_layers"]), strict=True)
    return model.eval()


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_jax(jax_run, use_kernels):
    model = _port_model(jax_run, use_kernels)
    assert model.vision_model.fused_stages == ((0, 1) if use_kernels else ())
    counts = (A.launches, K.launches)
    with torch.inference_mode():
        log_probs, loss, feats = model(
            torch.from_numpy(jax_run["ids"]), torch.from_numpy(jax_run["mask"]),
            torch.from_numpy(jax_run["images"]),
            annotation_ids=torch.from_numpy(jax_run["labels"]),
            return_features=True)
    assert (A.launches, K.launches) == counts      # CPU: no kernel launches
    np.testing.assert_allclose(log_probs.numpy(), jax_run["log_probs"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(feats["features"].numpy(),
                               jax_run["features"], rtol=1e-4, atol=1e-4)


def test_vision_features_route_matches_full_forward(jax_run):
    model = _port_model(jax_run, use_kernels=True)
    ids, mask = (torch.from_numpy(jax_run[k]) for k in ("ids", "mask"))
    images = torch.from_numpy(jax_run["images"])
    with torch.inference_mode():
        feats = model.compute_vision_features(images)
        direct, _ = model(ids, mask, images)
        cached, _ = model(ids, mask, vision_features=feats)
    torch.testing.assert_close(cached, direct, rtol=0, atol=0)


def test_state_dict_from_jax_equals_reference_exporter(jax_run):
    ours = state_dict_from_jax(jax_run["params"], "resnet50", BLOCKS,
                               T5_KW["num_layers"])
    theirs = export_resnet_vqa_checkpoint(jax_run["params"], "resnet50",
                                          BLOCKS, T5_KW["num_layers"])
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key], value), key


def test_port_keys_are_the_reference_layout():
    model = ResnetVQAModel(ANSWERS, vision_model_name="resnet50",
                           t5_config=T5Config(**T5_KW),
                           num_attention_blocks=BLOCKS,
                           sga_config=AttentionConfig(**SGA_KW),
                           device="cpu")
    keys = set(model.state_dict())
    for key in ("vision_model.layer1.0.conv1.weight",
                "vision_model.layer2.0.downsample.1.num_batches_tracked",
                "vision_model.fc.weight",
                "lang_model.block.0.layer.0.SelfAttention.q.weight",
                "lang_model.block.0.layer.0.SelfAttention."
                "relative_attention_bias.weight",
                "lang_model.embed_tokens.weight",
                "sga_modules.0.mhatt1.linear_v.weight",
                "sga_modules.1.norm3.norm.bias",
                "attention_pooler.attention.0.weight",
                "downscale_layer.weight", "upscale_layer.weight",
                "classification_layer.bias"):
        assert key in keys, key
    assert model.frozen_modules() == ("vision_model",)


def test_same_generator_seed_gives_same_weights():
    def build(seed):
        return ResnetVQAModel(
            ANSWERS, vision_model_name="resnet18",
            t5_config=T5Config(**T5_KW), num_attention_blocks=1,
            sga_config=AttentionConfig(**SGA_KW), device="cpu",
            generator=torch.Generator().manual_seed(seed)).state_dict()
    a, b, c = build(5), build(5), build(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classification_layer.weight"],
                           c["classification_layer.weight"])
