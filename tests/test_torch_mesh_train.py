"""The port's train step on a (data, model) mesh against the JAX package's
step on a JAX mesh of the same shape, and against the port's own
single-device run.

For each family (here the CNN one with a ResNet-18 tower;
``test_torch_mesh_frcnn_train.py`` runs Faster-RCNN and
``test_torch_mesh_vit_train.py`` ViT + T5 encoder-decoder and ViT x
RoBERTa through this module's helpers, each file on its own), small widths, dropout 0, the JAX
weights through the weight bridge, B=4, 2 steps of the production
optimizer (global-norm clip 1.0, AdamW with wd 0.1 and AMSGrad, a distinct
LR per group, warmup 1):

* JAX: ``make_mesh(dp, tp)`` over the first dp x tp of the conftest's 8
  virtual CPU devices, params and batches placed by its sharding rules,
  the jitted ``make_train_step``; for the CNN family at each of the three
  shapes, for the others at 2x2 (each JAX compile takes ~15 s here; JAX's
  own mesh tests hold its shapes to one another).
* The port: 4 gloo ranks in processes of their own
  (``tests/test_torch_mesh_workers.py``, which imports no JAX) run the
  one-device mesh (1, 1) and the meshes dp=2, tp=2 and 2x2 in turn: each
  rank takes its rows, the model is split over the model axis, DDP
  averages over the data axis.

Tolerances: against JAX those of the single-device step parity
(``tests/test_torch_train_step.py``): losses rtol/atol 3e-4, trainable
parameters rtol 5e-3 / atol 5e-4. Against the port's own one-device run:
losses within 1e-5 relative, trainable parameters within the same rtol
5e-3 / atol 5e-4 (AdamW moves an element whose gradient is near 0 by its
LR in the direction of the gradient's sign, which a sum in another order
can flip); frozen parameters equal to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from t5_resnet_vqa_tpu.core.config import LRSchedulerConfig as JaxSchedCfg
from t5_resnet_vqa_tpu.core.config import OptimizerConfig as JaxOptCfg
from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxResnet
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.parallel import make_mesh, shard_batch, shard_params
from t5_resnet_vqa_tpu.train.optimizer import build_optimizer as jax_build
from t5_resnet_vqa_tpu.train.trainer import make_train_step as jax_step
from t5_resnet_vqa_torch.models import ViTConfig
from t5_resnet_vqa_torch.parallel import launch
from t5_resnet_vqa_torch.train.optimizer import FROZEN_LABEL, label_params
from t5_resnet_vqa_torch.utils import (
    cross_attention_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
    state_dict_from_jax,
    vit_state_dict_from_jax,
)

import test_torch_cross_attention as cross
import test_torch_faster_rcnn as frcnn
import test_torch_vit_train_step as vit
import test_torch_mesh_workers as W
from test_torch_train_step import _random_params

B = 4
STEPS = 2
WARMUP = 1
SHAPES = [(2, 1), (1, 2), (2, 2)]
# the JAX meshes each family is held against, shape for shape
JAX_SHAPES = {"cnn": SHAPES, "faster_rcnn": [(2, 2)], "vit": [(2, 2)],
              "cross": [(2, 2)]}
OPT_KW = dict(type="AdamW", vision_lr=8e-3, lm_encoder_lr=1e-3,
              lm_decoder_lr=3e-4, fusion_lr=5e-4, classifier_lr=1e-2,
              default_lr=2e-3, kwargs={"weight_decay": 0.1, "amsgrad": True})
T5_KW = dict(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_decoder_layers=2, num_heads=4, dropout_rate=0.0)
SGA_KW = dict(hidden_size=32, num_heads=4, ff_size=32, dropout_rate=0.0)
FAMILIES = ("cnn",)
LOSS_TOL = dict(rtol=3e-4, atol=3e-4)
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)

_RUNS = {}


def _cnn_batch(rng, answers):
    mask = np.ones((B, 16), np.int32)
    mask[1, 9:] = 0
    return dict(question_input_ids=rng.integers(2, 256, (B, 16)).astype(
        np.int32) * mask, question_attention_masks=mask,
        image_tensors=rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
        annotation_ids=rng.integers(0, answers, B).astype(np.int32))


def family_case(name, rng):
    """(JAX model, batches, port model kwargs, weight bridge)."""
    if name == "cnn":
        model = JaxResnet(answer_spaces=7, vision_model_name="resnet18",
                          t5_config=JaxT5Config(**T5_KW),
                          num_attention_blocks=2,
                          sga_config=JaxAttentionConfig(**SGA_KW))
        kw = dict(answers=7, vision_model_name="resnet18", t5=T5_KW,
                  sga=SGA_KW, num_attention_blocks=2)
        return (model, [_cnn_batch(rng, 7) for _ in range(STEPS)], kw,
                lambda p: state_dict_from_jax(p, "resnet18", 2,
                                              T5_KW["num_layers"]))
    if name == "faster_rcnn":
        kw = dict(answers=frcnn.ANSWERS, t5=T5_KW, sga=SGA_KW,
                  num_attention_blocks=frcnn.BLOCKS,
                  fpn_channels=frcnn.FPN_CHANNELS)
        return (frcnn.jax_model(False, T5_KW, SGA_KW),
                [_cnn_batch(rng, frcnn.ANSWERS) for _ in range(STEPS)], kw,
                lambda p: faster_rcnn_state_dict_from_jax(
                    p, frcnn.BLOCKS, T5_KW["num_layers"]))
    if name == "vit":
        kw = dict(answers=vit.ANSWERS, t5=vit.T5_KW, vit=vit.VIT_KW,
                  fusing_dropout=0.0)
        return (vit.jax_vit_model(),
                [vit.make_batch(rng, b=B) for _ in range(STEPS)], kw,
                lambda p: vit_state_dict_from_jax(
                    p, vit.VIT_KW["num_layers"], vit.T5_KW["num_layers"]))
    kw = dict(answers=cross.ANSWERS,
              vit=dataclasses.asdict(ViTConfig.tiny()),
              roberta=dict(dropout_rate=0.0))
    return (cross.jax_model(),
            [cross.make_batch(rng, b=B) for _ in range(STEPS)], kw,
            lambda p: cross_attention_state_dict_from_jax(p, cross.LAYERS))


def _family(name, rng):
    """(JAX model, numpy params, batches, port model kwargs, bridge)."""
    model, batches, kw, bridge = family_case(name, rng)
    init = {"cnn": lambda m, r, b: _random_params(m, b, r),
            "faster_rcnn": frcnn.init_params,
            "vit": vit.jax_vit_params, "cross": cross.init_params}[name]
    params = init(model, rng, batches[0])
    return model, params, batches, kw, bridge


def _jax_mesh_steps(model, params, batches, shape):
    """Losses and final params of the JAX step on a JAX mesh of ``shape``."""
    dp, tp = shape
    mesh = make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    tx, _, _ = jax_build(JaxOptCfg(**OPT_KW),
                         JaxSchedCfg(num_warmup_steps=WARMUP), STEPS,
                         gradient_clipping=1.0,
                         frozen_modules=model.frozen_modules())
    p = shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    state = jax.jit(tx.init)(p)
    step = jax.jit(jax_step(model, tx))
    losses = []
    for batch in batches:
        p, state, loss, _ = step(p, state, shard_batch(batch, mesh),
                                 jax.random.PRNGKey(1))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


def _run(name, tmp_path_factory):
    if name not in _RUNS:
        rng = np.random.default_rng(7)
        model, params, batches, kw, bridge = _family(name, rng)
        jax_runs = {shape: _jax_mesh_steps(model, params, batches, shape)
                    for shape in JAX_SHAPES[name]}
        spec = dict(family=name, model=kw, state=bridge(params),
                    batches=batches, warmup=WARMUP, optimizer=OPT_KW)
        port = launch.spawn(
            W.train_steps, 4, (spec, [(1, 1)] + SHAPES),
            store_dir=str(tmp_path_factory.mktemp(f"store_{name}")))[0]
        port_model = W.build_model(name, kw)
        labels = label_params(port_model,
                              frozen_modules=port_model.frozen_modules())
        _RUNS[name] = dict(jax=jax_runs, bridge=bridge, labels=labels,
                           one=port[0], mesh=dict(zip(SHAPES, port[1:])))
    return _RUNS[name]


def check_against_jax_mesh(family, shape, tmp_path_factory):
    run = _run(family, tmp_path_factory)
    jax_losses, jax_final = run["jax"][shape]
    got = run["mesh"][shape]
    np.testing.assert_allclose(got["losses"], jax_losses, **LOSS_TOL)
    want = run["bridge"](jax_final)
    trained = [n for n, lab in run["labels"].items() if lab != FROZEN_LABEL]
    assert len(trained) > 20
    for name in trained:
        np.testing.assert_allclose(got["state"][name], want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


def check_against_one_device(family, tmp_path_factory):
    run = _run(family, tmp_path_factory)
    one = run["one"]
    assert one["losses"][0] != one["losses"][-1]
    for shape in SHAPES:
        got = run["mesh"][shape]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5,
                                   atol=0)
        assert set(got["state"]) == set(one["state"])
        for name, lab in run["labels"].items():
            if lab == FROZEN_LABEL:
                np.testing.assert_array_equal(got["state"][name],
                                              one["state"][name], name)
            else:
                np.testing.assert_allclose(got["state"][name],
                                           one["state"][name], err_msg=name,
                                           **PARAM_TOL)


@pytest.mark.parametrize("family,shape",
                         [(f, s) for f in FAMILIES for s in JAX_SHAPES[f]],
                         ids=lambda x: x if isinstance(x, str)
                         else f"{x[0]}x{x[1]}")
def test_mesh_steps_match_jax_mesh(family, shape, tmp_path_factory):
    check_against_jax_mesh(family, shape, tmp_path_factory)


@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_steps_match_one_device(family, tmp_path_factory):
    check_against_one_device(family, tmp_path_factory)
