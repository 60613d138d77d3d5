"""The port's Faster-RCNN family against the JAX package: ``FPN`` and
``FasterRcnnVQAModel``.

The FPN at fp32 over random [C2..C5] maps of a 64x64 image's geometry
(16x16 down to 2x2, narrow channels): every level and ``pool`` within
1e-5, and the ``pool``-only path equal to the all-levels one. The nearest
2x upsampling of the top-down pass (``F.interpolate``) equals JAX's
``jax.image.resize(..., "nearest")`` at an exact 2x.

The model: ResNet-50 body + FPN (16 channels) + T5 (d_model 32, 2 layers)
+ SGA (hidden 32, 4 heads, 2 blocks) on 64x64 uint8 images, so the
``pool`` level is 1x1. JAX params (with randomised BatchNorms, so the fold
matters) reach the port through ``faster_rcnn_state_dict_from_jax`` and a
strict load. The port runs with its kernel routes on (stages 0-1 of the
body through the fused bottleneck, the SGA cores through fused attention:
their plain versions on the CPU) and off. Log-probs and loss agree with
JAX ``model.apply`` to atol 1e-4 in fp32, and so do the FPN levels of
``return_features`` (rtol/atol 1e-4, after 50 layers) and
``compute_vision_features``.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from t5_resnet_vqa_tpu.models.faster_rcnn_vqa import (
    FasterRcnnVQAModel as JaxModel,
)
from t5_resnet_vqa_tpu.models.fpn import FPN as JaxFPN
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.utils.torch_export import (
    export_faster_rcnn_vqa_checkpoint,
)
from t5_resnet_vqa_torch.models import FPN, FasterRcnnVQAModel, T5Config
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import attention as A
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.utils import faster_rcnn_state_dict_from_jax
from t5_resnet_vqa_torch.utils.weights import export_fpn

torch.set_num_threads(4)

ANSWERS = 19
FPN_CHANNELS = 16
T5_KW = dict(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_decoder_layers=2, num_heads=4)
SGA_KW = dict(hidden_size=32, num_heads=4, ff_size=32)
BLOCKS = 2
LEVELS = ("0", "1", "2", "3", "pool")


def jax_model(fine_tune_vision=False, t5_kw=T5_KW, sga_kw=SGA_KW):
    return JaxModel(answer_spaces=ANSWERS, t5_config=JaxT5Config(**t5_kw),
                    num_attention_blocks=BLOCKS,
                    sga_config=JaxAttentionConfig(**sga_kw),
                    fpn_channels=FPN_CHANNELS,
                    fine_tune_vision=fine_tune_vision)


def port_model(params=None, use_kernels=True, fine_tune_vision=False,
               t5_kw=T5_KW, answers=ANSWERS, sga_kw=SGA_KW):
    model = FasterRcnnVQAModel(
        answers, t5_config=T5Config(**t5_kw), num_attention_blocks=BLOCKS,
        sga_config=AttentionConfig(**sga_kw), fpn_channels=FPN_CHANNELS,
        fine_tune_vision=fine_tune_vision, use_kernels=use_kernels,
        device="cpu")
    if params is not None:
        model.load_state_dict(faster_rcnn_state_dict_from_jax(
            params, BLOCKS, t5_kw["num_layers"]), strict=True)
    return model


def randomize_batchnorms(params, rng):
    """Non-trivial frozen BatchNorms in the body: the kernel folds them."""
    for block in params["vision_model"].values():
        for name, sub in block.items():
            if "bn" in name:
                n = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
                sub["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
    return params


def init_params(model, rng, batch):
    params = model.init(jax.random.PRNGKey(0), **batch)["params"]
    return randomize_batchnorms(jax.tree_util.tree_map(np.array, params),
                                rng)


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    model = jax_model()
    ids = rng.integers(2, 256, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 7:] = 0
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    labels = np.array([3, 11], np.int32)
    params = init_params(model, rng, dict(question_input_ids=ids,
                                          question_attention_masks=mask,
                                          image_tensors=images))
    log_probs, loss, levels = model.apply(
        {"params": params}, question_input_ids=ids,
        question_attention_masks=mask, image_tensors=images,
        annotation_ids=labels, return_features=True)
    features = model.compute_vision_features(params, images)
    return dict(params=params, ids=ids, mask=mask, images=images,
                labels=labels, log_probs=np.asarray(log_probs),
                loss=float(loss),
                levels={k: np.asarray(v) for k, v in levels.items()},
                features=np.asarray(features))


def test_nearest_upsample_matches_jax_resize():
    x = np.random.default_rng(1).normal(size=(2, 3, 5, 7)).astype(np.float32)
    want = jax.image.resize(x.transpose(0, 2, 3, 1), (2, 10, 14, 3),
                            method="nearest")
    got = F.interpolate(torch.from_numpy(x), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("all_levels", [True, False])
def test_fpn_matches_jax(all_levels):
    rng = np.random.default_rng(2)
    channels = (8, 12, 16, 20)
    feats = [rng.normal(size=(2, s, s, c)).astype(np.float32)
             for s, c in zip((16, 8, 4, 2), channels)]
    jfpn = JaxFPN(FPN_CHANNELS)
    params = jax.tree_util.tree_map(
        np.asarray, jfpn.init(jax.random.PRNGKey(3), feats)["params"])
    params = jax.tree_util.tree_map(
        lambda p: rng.normal(0.0, 0.3, p.shape).astype(np.float32), params)
    want = jfpn.apply({"params": params}, feats)
    fpn = FPN(channels, FPN_CHANNELS)
    state = {}
    export_fpn(state, params, prefix="fpn")
    fpn.load_state_dict({k[4:]: v for k, v in state.items()}, strict=True)
    x = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        got = fpn(x, all_levels=all_levels)
        full = fpn(x, all_levels=True)
    assert tuple(got) == (LEVELS if all_levels else ("pool",))
    for name, value in got.items():
        np.testing.assert_allclose(value.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert torch.equal(got["pool"], full["pool"])
    assert tuple(full["pool"].shape) == (2, FPN_CHANNELS, 1, 1)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_jax(jax_run, use_kernels):
    model = port_model(jax_run["params"], use_kernels).eval()
    assert model.vision_model.body.fused_stages == \
        ((0, 1) if use_kernels else ())
    counts = (A.launches, K.launches)
    ids, mask, images = (torch.from_numpy(jax_run[k])
                         for k in ("ids", "mask", "images"))
    with torch.inference_mode():
        log_probs, loss, levels = model(
            ids, mask, images,
            annotation_ids=torch.from_numpy(jax_run["labels"]),
            return_features=True)
        plain, plain_loss = model(ids, mask, images,
                                  annotation_ids=torch.from_numpy(
                                      jax_run["labels"]))
    assert (A.launches, K.launches) == counts      # CPU: no kernel launches
    np.testing.assert_allclose(log_probs.numpy(), jax_run["log_probs"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=0,
                               atol=1e-4)
    # the pool-only path gives the same numbers as the all-levels one
    assert torch.equal(plain, log_probs) and torch.equal(plain_loss, loss)
    assert tuple(levels) == LEVELS
    for name in LEVELS:
        np.testing.assert_allclose(levels[name].numpy(),
                                   jax_run["levels"][name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_vision_features_are_the_pool_level(jax_run):
    model = port_model(jax_run["params"]).eval()
    ids, mask, images = (torch.from_numpy(jax_run[k])
                         for k in ("ids", "mask", "images"))
    with torch.inference_mode():
        feats = model.compute_vision_features(images)
        direct, _, levels = model(ids, mask, images, return_features=True)
        cached, _ = model(ids, mask, vision_features=feats)
    assert tuple(feats.shape) == (2, 1, 1, FPN_CHANNELS)
    torch.testing.assert_close(feats, levels["pool"], rtol=0, atol=0)
    torch.testing.assert_close(cached, direct, rtol=0, atol=0)
    np.testing.assert_allclose(feats.numpy(), jax_run["features"],
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="in-graph tower"):
        model(ids, mask, vision_features=feats, return_features=True)


def test_state_dict_from_jax_equals_reference_exporter(jax_run):
    ours = faster_rcnn_state_dict_from_jax(jax_run["params"], BLOCKS,
                                           T5_KW["num_layers"])
    theirs = export_faster_rcnn_vqa_checkpoint(jax_run["params"], BLOCKS,
                                               T5_KW["num_layers"])
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key], value), key
    assert sorted(port_model().state_dict()) == sorted(theirs)


def test_port_keys_are_the_reference_layout():
    model = port_model()
    keys = set(model.state_dict())
    for key in ("vision_model.body.conv1.weight",
                "vision_model.body.layer2.0.downsample.1.running_var",
                "vision_model.body.layer4.2.bn3.weight",
                "vision_model.fpn.inner_blocks.3.bias",
                "vision_model.fpn.layer_blocks.0.weight",
                "upscale_layer.weight", "lang_model.embed_tokens.weight",
                "sga_modules.1.norm3.norm.bias",
                "attention_pooler.attention.0.weight",
                "classification_layer.bias"):
        assert key in keys, key
    assert not any("num_batches_tracked" in k or ".fc." in k for k in keys)
    assert not any(k.startswith("downscale_layer") for k in keys)
    assert model.frozen_modules() == ("vision_model", "fpn")
    assert port_model(fine_tune_vision=True).frozen_modules() == ()
    assert port_model(fine_tune_vision=True).vision_model.body \
        .fused_stages == ()
