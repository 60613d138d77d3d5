"""The port's train step on the ViT family against the JAX package's
``make_train_step``, and the ViT family's LR groups against JAX's
``label_params``.

A small ``VitVQAModel``: ViT hidden 32 with 2 layers over 32x32 images in
16x16 patches (5 tokens), T5 d_model 32 with 1 encoder and 1 decoder layer
over one tied table, 13 answers, B=3, dropout 0 and fusing dropout 0 (the
two frameworks draw different dropout bits). The JAX params (``model.init``
with a random CLS token and position embeddings) reach the port through
``vit_state_dict_from_jax`` and a strict load.

* Groups: every port parameter gets the group that JAX's ``label_params``
  gives its counterpart, whose name comes from ``vit_state_dict_from_jax``
  (the layout of ``export_vit_vqa_checkpoint``): the decoder's 15 tensors
  train at ``lm_decoder_lr``, the encoder and the tied table (counted once)
  at ``lm_encoder_lr``.
* Steps: 5 steps of each side's production optimizer on the same batches
  (global-norm clip 1.0, AdamW(wd 0.1, amsgrad), a distinct LR per group,
  ``lm_decoder`` apart from ``lm_encoder``, warmup 2 of the HF linear
  schedule), with the kernel route on (its plain version on the CPU) and
  off. Losses within rtol/atol 3e-4, trainable params within rtol 5e-3 /
  atol 5e-4 (``tests/test_torch_train_step.py`` gives the reasons); the
  frozen tower stays bitwise unchanged.
* The fine-tuned tower: with ``fine_tune_vision`` every ViT parameter gets a
  gradient, within 1e-4 of ``jax.grad`` of the JAX model relative to the
  largest element of that parameter's gradient. The key biases' gradients
  are zero in exact arithmetic (the softmax ignores a shift of a row's
  scores): on both sides they stay under 1e-6 of the tower's largest
  gradient element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import LRSchedulerConfig as JaxSchedCfg
from t5_resnet_vqa_tpu.core.config import OptimizerConfig as JaxOptCfg
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.models.vit_vqa import VitVQAModel as JaxModel
from t5_resnet_vqa_tpu.train.optimizer import build_optimizer as jax_build
from t5_resnet_vqa_tpu.train.optimizer import label_params as jax_labels
from t5_resnet_vqa_tpu.train.trainer import make_train_step as jax_step
from t5_resnet_vqa_torch.core.config import LRSchedulerConfig, OptimizerConfig
from t5_resnet_vqa_torch.models import T5Config, ViTConfig, VitVQAModel
from t5_resnet_vqa_torch.train import (
    build_optimizer,
    label_params,
    make_train_step,
)
from t5_resnet_vqa_torch.train.optimizer import FROZEN_LABEL, GROUPS
from t5_resnet_vqa_torch.utils import vit_state_dict_from_jax

torch.set_num_threads(4)

ANSWERS = 13
B = 3
STEPS = 5
WARMUP = 2
VOCAB = 64
VIT_KW = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
              patch_size=16, image_size=32)
T5_KW = dict(vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=64, num_layers=1,
             num_decoder_layers=1, num_heads=4, dropout_rate=0.0)
OPT_KW = dict(type="AdamW", vision_lr=8e-3, lm_encoder_lr=1e-3,
              lm_decoder_lr=3e-4, fusion_lr=5e-4, classifier_lr=1e-2,
              default_lr=5e-5, kwargs={"weight_decay": 0.1, "amsgrad": True})


def jax_vit_model(fine_tune_vision=False, t5_kw=T5_KW):
    return JaxModel(answer_spaces=ANSWERS, t5_config=JaxT5Config(**t5_kw),
                    vit_config=JaxViTConfig(**VIT_KW), fusing_dropout=0.0,
                    fine_tune_vision=fine_tune_vision)


def port_vit_model(params=None, use_kernels=True, fine_tune_vision=False,
                   t5_kw=T5_KW, answers=ANSWERS):
    model = VitVQAModel(answers, t5_config=T5Config(**t5_kw),
                        vit_config=ViTConfig(**VIT_KW),
                        fine_tune_vision=fine_tune_vision,
                        use_kernels=use_kernels, fusing_dropout=0.0,
                        device="cpu")
    if params is not None:
        model.load_state_dict(vit_state_dict_from_jax(
            params, VIT_KW["num_layers"], t5_kw["num_layers"]), strict=True)
    return model.train()


def make_batch(rng, b=B, vocab=VOCAB, answers=ANSWERS):
    """One ViT-family batch: uint8 images, questions of 16 and decoder
    prompts of 20 tokens, rows of different lengths."""
    q_mask = np.zeros((b, 16), np.int32)
    d_mask = np.zeros((b, 20), np.int32)
    for i in range(b):
        n = int(rng.integers(4, 16))
        q_mask[i, :n] = 1
        d_mask[i, :n + 2] = 1
    return dict(
        question_input_ids=rng.integers(2, vocab, (b, 16)).astype(np.int32)
        * q_mask,
        question_attention_masks=q_mask,
        decoder_question_input_ids=rng.integers(2, vocab, (b, 20)).astype(
            np.int32) * d_mask,
        decoder_question_attention_masks=d_mask,
        pixel_values=rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
        annotation_ids=rng.integers(0, answers, b).astype(np.int32))


def jax_vit_params(model, rng, batch):
    """``model.init`` params as numpy, with a random CLS token and position
    embeddings (init gives zeros)."""
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), **batch)["params"])
    vm = dict(params["vision_model"])
    for k in ("cls_token", "position_embeddings"):
        vm[k] = rng.normal(0.0, 0.5, vm[k].shape).astype(np.float32)
    return {**params, "vision_model": vm}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    batches = [make_batch(rng) for _ in range(STEPS)]
    model = jax_vit_model()
    params = jax_vit_params(model, rng, batches[0])
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
    return dict(params=params, batches=batches, losses=losses,
                final=jax.tree_util.tree_map(np.asarray, p))


def _port_optimizer(model, opt_kw=OPT_KW):
    return build_optimizer(model, OptimizerConfig(**opt_kw),
                           LRSchedulerConfig(num_warmup_steps=WARMUP), STEPS,
                           frozen_modules=model.frozen_modules())


def _jax_labels_by_port_name(params, frozen_modules):
    """{port state_dict key: JAX label}: each JAX leaf is replaced by an
    array filled with its label's code, and the weight bridge carries the
    codes to the port's names (transposes keep a constant array constant)."""
    codes = {g: i for i, g in enumerate(GROUPS + (FROZEN_LABEL,))}
    labels = jax_labels(params, frozen_modules=frozen_modules)
    coded = jax.tree_util.tree_map(
        lambda leaf, lab: np.full(np.shape(leaf), codes[lab], np.float32),
        params, labels)
    names = {i: g for g, i in codes.items()}
    out = {}
    for key, t in vit_state_dict_from_jax(coded, VIT_KW["num_layers"],
                                          T5_KW["num_layers"]).items():
        values = set(t.flatten().tolist())
        assert len(values) == 1, key
        out[key] = names[int(values.pop())]
    return out


@pytest.mark.parametrize("fine_tune_vision", [False, True])
def test_vit_groups_match_jax_labels(jax_run, fine_tune_vision):
    model = port_vit_model(jax_run["params"],
                           fine_tune_vision=fine_tune_vision)
    frozen = model.frozen_modules()
    ours = label_params(model, frozen_modules=frozen)
    theirs = _jax_labels_by_port_name(jax_run["params"], frozen)
    assert set(ours) <= set(theirs)
    assert "lang_model.shared.weight" in ours
    for name, label in ours.items():
        assert label == theirs[name], (name, label, theirs[name])
    decoder = [n for n in ours if n.startswith("lang_model.decoder.")]
    assert len(decoder) == 15
    assert {ours[n] for n in decoder} == {"lm_decoder"}
    assert ours["lang_model.shared.weight"] == "lm_encoder"
    assert {ours[n] for n in ours if n.startswith("vision_model.")} == \
        {"vision" if fine_tune_vision else FROZEN_LABEL}

    # the reference config's LRs reach the right groups: the decoder trains
    # at lm_decoder_lr, the table once, at lm_encoder_lr
    optimizer, _, _, trainable = _port_optimizer(model)
    named = dict(model.named_parameters())
    for group in optimizer.param_groups:
        assert group["initial_lr"] == OPT_KW[f"{group['group']}_lr"]
        assert {n for n, p in named.items()
                if any(p is q for q in group["params"])} == {
            n for n, lab in ours.items() if lab == group["group"]}
    assert len(trainable) == sum(lab != FROZEN_LABEL for lab in ours.values())
    table = [p for p in trainable if p is model.lang_model.shared.weight]
    assert len(table) == 1


@pytest.mark.parametrize("use_kernels", [True, False])
def test_vit_train_steps_match_jax(jax_run, use_kernels):
    model = port_vit_model(jax_run["params"], use_kernels)
    assert model.vision_model.encoder.layer[0].attention.attention \
        .use_kernel is use_kernels
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler, _, trainable = _port_optimizer(model)
    step = make_train_step(model, optimizer, scheduler, trainable, 1.0)
    losses = [float(step(torch_batch(b))[0]) for b in jax_run["batches"]]

    np.testing.assert_allclose(losses, jax_run["losses"], rtol=3e-4,
                               atol=3e-4)
    assert losses[0] != losses[-1]
    labels = label_params(model, frozen_modules=model.frozen_modules())
    want = vit_state_dict_from_jax(jax_run["final"], VIT_KW["num_layers"],
                                   T5_KW["num_layers"])
    got = model.state_dict()
    trained = [n for n, lab in labels.items() if lab != FROZEN_LABEL]
    assert len(trained) == 30          # the ViT's 40 tensors are frozen
    assert any(labels[n] == "lm_decoder" for n in trained)
    for name in trained:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=name)
        assert not torch.equal(got[name], initial[name]), name
    frozen = [k for k in got if k.startswith("vision_model.")]
    assert len(frozen) > 20
    for name in frozen:
        assert torch.equal(got[name], initial[name]), name


def test_vit_fine_tuned_tower_gradients_match_jax(jax_run):
    batch = jax_run["batches"][0]
    model = port_vit_model(jax_run["params"], use_kernels=True,
                           fine_tune_vision=True)
    assert model.frozen_modules() == ()
    _, loss = model(**torch_batch(batch))
    loss.backward()

    jmodel = jax_vit_model(fine_tune_vision=True)

    def loss_fn(p):
        return jmodel.apply({"params": p}, **batch)[1]

    grads = jax.jit(jax.grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jax_run["params"]))
    want = vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), VIT_KW["num_layers"],
        T5_KW["num_layers"])
    vision = dict(model.vision_model.named_parameters())
    assert len(vision) == 40
    largest = max(float(np.abs(want[f"vision_model.{n}"].numpy()).max())
                  for n in vision)
    for name, p in vision.items():
        assert p.grad is not None, name
        w = want[f"vision_model.{name}"].numpy()
        got = p.grad.numpy()
        if name.endswith("attention.attention.key.bias"):
            # zero in exact arithmetic: a shift of every score in a row
            # leaves the softmax unchanged; both sides hold rounding noise
            assert np.abs(got).max() <= 1e-6 * largest, name
            assert np.abs(w).max() <= 1e-6 * largest, name
            continue
        assert float(np.abs(got).max()) > 0, name
        err = np.abs(got - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def test_vit_model_options():
    """``fusing_dropout`` sets the fusing layer's rate (the JAX field of the
    same name, 0.5 by default), and the port's ViT, which has no dropout,
    is deterministic for the feature cache."""
    model = VitVQAModel(ANSWERS, t5_config=T5Config(**T5_KW),
                        vit_config=ViTConfig(**VIT_KW), device="cpu")
    assert model.fusing_layer[2].p == 0.5
    assert model.vision_tower_deterministic() is True
    assert JaxModel(answer_spaces=ANSWERS).fusing_dropout == 0.5
    assert JaxViTConfig(**VIT_KW).dropout_rate == 0.0
    assert port_vit_model().fusing_layer[2].p == 0.0
