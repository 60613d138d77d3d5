"""The port's train step on the Faster-RCNN and cross-attention families
against the JAX package's ``make_train_step``, and their LR groups against
JAX's ``label_params``.

Models: the small ones of ``test_torch_faster_rcnn.py`` (ResNet-50 body +
FPN 16 + T5 d_model 32 + 2 SGA blocks, 64x64 images, randomised
BatchNorms) and ``test_torch_cross_attention.py`` (tiny ViT x tiny RoBERTa,
2 layers, 32x32 images), dropout 0 everywhere (the two frameworks draw
different dropout bits), B=2, from the same JAX params through the weight
bridge.

* Groups: every port parameter gets the group JAX's ``label_params`` gives
  its counterpart (named through the bridge), frozen and fine-tuned: the
  FPN (``vision_model.fpn``, JAX's ``fpn``) is frozen with the body or
  trains at ``vision_lr``; the RoBERTa and ViT layers (JAX's
  ``roberta_layer_{i}`` / ``vit_layer_{i}``, in no group of the map) train
  at ``default_lr``, and the ViT embedding at ``vision_lr`` when
  fine-tuned.
* Steps: 2 steps of each side's production optimizer (clip 1.0,
  AdamW(wd 0.1, amsgrad), a distinct LR per group, warmup 1), frozen and
  fine-tuned, the port's kernel routes on (their plain versions on the
  CPU): losses within 1e-4 relative, trainable parameters within rtol
  5e-3 / atol 5e-4 (``tests/test_torch_train_step.py`` gives the reasons),
  frozen modules bitwise unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import LRSchedulerConfig as JaxSchedCfg
from t5_resnet_vqa_tpu.core.config import OptimizerConfig as JaxOptCfg
from t5_resnet_vqa_tpu.train.optimizer import build_optimizer as jax_build
from t5_resnet_vqa_tpu.train.optimizer import label_params as jax_labels
from t5_resnet_vqa_tpu.train.trainer import make_train_step as jax_step
from t5_resnet_vqa_torch.core.config import LRSchedulerConfig, OptimizerConfig
from t5_resnet_vqa_torch.train import (
    build_optimizer,
    label_params,
    make_train_step,
)
from t5_resnet_vqa_torch.train.optimizer import FROZEN_LABEL, GROUPS
from t5_resnet_vqa_torch.utils import (
    cross_attention_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
)

import test_torch_cross_attention as cross
import test_torch_faster_rcnn as frcnn

torch.set_num_threads(4)

B = 2
STEPS = 2
WARMUP = 1
OPT_KW = dict(type="AdamW", vision_lr=8e-3, lm_encoder_lr=1e-3,
              lm_decoder_lr=3e-4, fusion_lr=5e-4, classifier_lr=1e-2,
              default_lr=2e-3, kwargs={"weight_decay": 0.1, "amsgrad": True})
T5_KW = dict(frcnn.T5_KW, dropout_rate=0.0)
SGA_KW = dict(frcnn.SGA_KW, dropout_rate=0.0)
FAMILIES = ("faster_rcnn", "cross")
_RUNS = {}


def _frcnn_batch(rng):
    ids = rng.integers(2, 256, (B, 16)).astype(np.int32)
    mask = np.ones((B, 16), np.int32)
    mask[1, 9:] = 0
    return dict(question_input_ids=ids * mask, question_attention_masks=mask,
                image_tensors=rng.integers(0, 256, (B, 64, 64, 3),
                                           dtype=np.uint8),
                annotation_ids=rng.integers(0, frcnn.ANSWERS, B).astype(
                    np.int32))


def _jax_model(family, fine_tune_vision):
    if family == "faster_rcnn":
        return frcnn.jax_model(fine_tune_vision, T5_KW, SGA_KW)
    return cross.jax_model(fine_tune_vision)


def _port_model(family, params, fine_tune_vision):
    if family == "faster_rcnn":
        model = frcnn.port_model(params, fine_tune_vision=fine_tune_vision,
                                 t5_kw=T5_KW, sga_kw=SGA_KW)
    else:
        model = cross.port_model(params, fine_tune_vision=fine_tune_vision)
    return model.train()


def _bridge(family, params):
    if family == "faster_rcnn":
        return faster_rcnn_state_dict_from_jax(params, frcnn.BLOCKS,
                                               T5_KW["num_layers"])
    return cross_attention_state_dict_from_jax(params, cross.LAYERS)


def _jax_run(family, fine_tune_vision):
    """Params, batches and 2 steps of the JAX model (cached per case)."""
    key = (family, fine_tune_vision)
    if key not in _RUNS:
        rng = np.random.default_rng(5)
        make = (_frcnn_batch if family == "faster_rcnn"
                else lambda r: cross.make_batch(r, B))
        batches = [make(rng) for _ in range(STEPS)]
        model = _jax_model(family, fine_tune_vision)
        init = (frcnn.init_params if family == "faster_rcnn"
                else cross.init_params)
        params = init(model, rng, batches[0])
        tx, _, _ = jax_build(JaxOptCfg(**OPT_KW),
                             JaxSchedCfg(num_warmup_steps=WARMUP), STEPS,
                             gradient_clipping=1.0,
                             frozen_modules=model.frozen_modules())
        step = jax.jit(jax_step(model, tx))
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = tx.init(p)
        losses = []
        for batch in batches:
            p, state, loss, _ = step(p, state, batch, jax.random.PRNGKey(1))
            losses.append(float(loss))
        _RUNS[key] = dict(params=params, batches=batches, losses=losses,
                          final=jax.tree_util.tree_map(np.asarray, p),
                          frozen=model.frozen_modules())
    return _RUNS[key]


def _jax_labels_by_port_name(family, params, frozen_modules):
    """{port state_dict key: JAX label}: each JAX leaf is replaced by an
    array filled with its label's code, and the weight bridge carries the
    codes to the port's names."""
    codes = {g: i for i, g in enumerate(GROUPS + (FROZEN_LABEL,))}
    labels = jax_labels(params, frozen_modules=frozen_modules)
    coded = jax.tree_util.tree_map(
        lambda leaf, lab: np.full(np.shape(leaf), codes[lab], np.float32),
        params, labels)
    names = {i: g for g, i in codes.items()}
    out = {}
    for key, t in _bridge(family, coded).items():
        if not t.is_floating_point():
            continue
        values = set(t.flatten().tolist())
        if key.endswith(("running_mean", "running_var")):
            continue                       # buffers the bridge makes up
        assert len(values) == 1, key
        out[key] = names[int(values.pop())]
    return out


@pytest.mark.parametrize("fine_tune_vision", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_groups_match_jax_labels(family, fine_tune_vision):
    run = _jax_run(family, False)
    model = _port_model(family, run["params"], fine_tune_vision)
    frozen = model.frozen_modules()
    assert frozen == _jax_model(family, fine_tune_vision).frozen_modules()
    ours = label_params(model, frozen_modules=frozen)
    theirs = _jax_labels_by_port_name(family, run["params"], frozen)
    assert set(ours) == set(theirs) - {
        k for k in theirs if k not in dict(model.named_parameters())}
    for name, label in ours.items():
        assert label == theirs[name], (name, label, theirs[name])
    if family == "faster_rcnn":
        fpn = {ours[n] for n in ours if n.startswith("vision_model.fpn.")}
        body = {ours[n] for n in ours if n.startswith("vision_model.body.")}
        want = "vision" if fine_tune_vision else FROZEN_LABEL
        assert fpn == body == {want}
    else:
        assert {ours[n] for n in ours
                if n.startswith("roberta_encoder_layers.")} == {"default"}
        assert {ours[n] for n in ours
                if n.startswith("vit_encoder_layers.")} == \
            {"default" if fine_tune_vision else FROZEN_LABEL}
        assert {ours[n] for n in ours if n.startswith("vit_embeddings.")} \
            == {"vision" if fine_tune_vision else FROZEN_LABEL}

    optimizer, _, _, trainable = build_optimizer(
        model, OptimizerConfig(**OPT_KW),
        LRSchedulerConfig(num_warmup_steps=WARMUP), STEPS,
        frozen_modules=frozen)
    named = dict(model.named_parameters())
    for group in optimizer.param_groups:
        assert group["initial_lr"] == OPT_KW[f"{group['group']}_lr"]
        assert {n for n, p in named.items()
                if any(p is q for q in group["params"])} == {
            n for n, lab in ours.items() if lab == group["group"]}
    assert len(trainable) == sum(lab != FROZEN_LABEL for lab in ours.values())


@pytest.mark.parametrize("fine_tune_vision", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_match_jax(family, fine_tune_vision):
    run = _jax_run(family, fine_tune_vision)
    model = _port_model(family, run["params"], fine_tune_vision)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler, _, trainable = build_optimizer(
        model, OptimizerConfig(**OPT_KW),
        LRSchedulerConfig(num_warmup_steps=WARMUP), STEPS,
        frozen_modules=model.frozen_modules())
    step = make_train_step(model, optimizer, scheduler, trainable, 1.0)
    losses = [float(step({k: torch.from_numpy(v) for k, v in b.items()})[0])
              for b in run["batches"]]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4, atol=0)
    assert losses[0] != losses[1]

    labels = label_params(model, frozen_modules=model.frozen_modules())
    want = _bridge(family, run["final"])
    got = model.state_dict()
    for name, label in labels.items():
        if label == FROZEN_LABEL:
            assert torch.equal(got[name], initial[name]), name
            continue
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=name)
    moved = [n for n, lab in labels.items() if lab != FROZEN_LABEL
             and not torch.equal(got[n], initial[n])]
    assert len(moved) > 0.9 * sum(lab != FROZEN_LABEL
                                  for lab in labels.values())
    vision = ("vision_model." if family == "faster_rcnn"
              else "vit_encoder_layers.")
    assert any(n.startswith(vision) for n in moved) is fine_tune_vision
