"""The port's train step against the JAX package's ``make_train_step``.

ResNet-50 (so that stages 0-1 take the fused route, through its plain
version on the CPU) + T5 (d_model 32, 2 layers) + SGA (hidden 32, 2 blocks),
B=2, 64x64 uint8 images, dropout 0 (the two frameworks draw different
dropout bits). The JAX params, with randomised BatchNorms, reach the port
through ``state_dict_from_jax`` and a strict load. Both sides take 5 steps of
their production optimizer on the same batches: global-norm clip 1.0,
AdamW(wd 0.1, amsgrad) with a distinct LR per group, warmup 2 of the HF
linear schedule.

Tolerances: losses rtol/atol 3e-4 and trainable params rtol 5e-3 / atol
5e-4, those of the JAX package's own golden test against the torch loop
(``tests/test_train_dynamics_parity.py``). They also cover the one known
difference: ``clip_grad_norm_`` divides by the norm plus 1e-6, optax by
the norm. Frozen modules (the tower, the unused projection twin, the
backbone's ``fc``) must stay bitwise unchanged.

The fine-tuned tower: with ``fine_tune_vision`` every vision parameter that
the forward reads gets a gradient, with the kernel routes on, and the
gradients match ``jax.grad`` of the JAX model to 1e-4 relative. Its
BatchNorms' affine pairs train as the JAX package's folded ``scale`` and
``bias`` do: ResNet-18 + the same small T5 and SGA, 2 steps at a tower LR
of 2e-4, and the updates compared, not the values (AdamW moves an element
by about its LR, far below a value tolerance at weights near 1). Each
BatchNorm weight's and bias's update must match the JAX one within 0.1 LR,
which a missing weight decay (0.15 LR at a weight of 1) would exceed. The
exception is an element whose clipped gradient, read from the port's first
moments, is under twice AdamW's eps (1e-8) at either step: there the update
follows the gradient's size, and the ~1e-8 summation noise of the stem's
gradients moves it (or flips its sign), so such an element is held to
0.25 LR. Those are under two thirds of the elements, and an element that
JAX moved by more than 1.2 LR must move the same way in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import LRSchedulerConfig as JaxSchedCfg
from t5_resnet_vqa_tpu.core.config import OptimizerConfig as JaxOptCfg
from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxModel
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.train.optimizer import build_optimizer as jax_build
from t5_resnet_vqa_tpu.train.optimizer import label_params as jax_labels
from t5_resnet_vqa_tpu.train.optimizer import (
    linear_schedule_with_warmup as jax_schedule,
)
from t5_resnet_vqa_tpu.train.trainer import make_train_step as jax_step
from t5_resnet_vqa_torch.core.config import LRSchedulerConfig, OptimizerConfig
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.models.resnet import ResNetBackbone
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.ops import bottleneck as K
from t5_resnet_vqa_torch.train import (
    build_optimizer,
    label_params,
    linear_schedule_with_warmup,
    make_train_step,
)
from t5_resnet_vqa_torch.train.optimizer import FROZEN_LABEL, unused_parameters
from t5_resnet_vqa_torch.utils import state_dict_from_jax

torch.set_num_threads(4)

ANSWERS = 19
B = 2
STEPS = 5
WARMUP = 2
T5_KW = dict(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_decoder_layers=2, num_heads=4, dropout_rate=0.0)
SGA_KW = dict(hidden_size=32, num_heads=4, ff_size=32, dropout_rate=0.0)
BLOCKS = 2
OPT_KW = dict(type="AdamW", vision_lr=8e-3, lm_encoder_lr=1e-3,
              fusion_lr=5e-4, classifier_lr=1e-2, default_lr=5e-5,
              kwargs={"weight_decay": 0.1, "amsgrad": True})


def _jax_model(fine_tune_vision=False, variant="resnet50"):
    return JaxModel(answer_spaces=ANSWERS, vision_model_name=variant,
                    t5_config=JaxT5Config(**T5_KW),
                    num_attention_blocks=BLOCKS,
                    sga_config=JaxAttentionConfig(**SGA_KW),
                    fine_tune_vision=fine_tune_vision)


def _port_model(params, use_kernels=True, fine_tune_vision=False):
    model = ResnetVQAModel(ANSWERS, vision_model_name="resnet50",
                           t5_config=T5Config(**T5_KW),
                           num_attention_blocks=BLOCKS,
                           sga_config=AttentionConfig(**SGA_KW),
                           fine_tune_vision=fine_tune_vision,
                           use_kernels=use_kernels, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, "resnet50", BLOCKS,
                                              T5_KW["num_layers"]),
                          strict=True)
    return model.train()


def _batches(rng):
    out = []
    for i in range(STEPS):
        mask = np.ones((B, 16), np.int32)
        mask[1, 8 + i:] = 0
        out.append(dict(
            question_input_ids=rng.integers(2, 256, (B, 16)).astype(np.int32),
            question_attention_masks=mask,
            image_tensors=rng.integers(0, 256, (B, 64, 64, 3),
                                       dtype=np.uint8),
            annotation_ids=rng.integers(0, ANSWERS, B).astype(np.int32)))
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _random_params(model, batch, rng):
    """The JAX model's param tree, drawn from ``rng`` by the shapes alone
    (``model.init`` of a ResNet-50 takes half a minute on the CPU):
    convolutions fan-in normal, other kernels N(0, 0.02), norms near 1,
    embeddings N(0, 1), and frozen BatchNorms with non-trivial scale and
    bias, so that the fused route's fold is exercised."""
    kw = {k: v for k, v in batch.items() if k != "annotation_ids"}
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), **kw))["params"]

    def draw(path, leaf):
        keys = [getattr(e, "key", "") for e in path]
        name, parent, shape = keys[-1], keys[-2], leaf.shape
        if name == "kernel" and len(shape) == 4:
            std = (2.0 / np.prod(shape[:3])) ** 0.5
            value = rng.normal(0.0, std, shape)
        elif name == "kernel":
            value = rng.normal(0.0, 0.02, shape)
        elif name == "embedding":
            value = rng.normal(0.0, 1.0, shape)
        elif name == "scale" and "bn" in parent:
            value = rng.uniform(0.5, 1.0, shape)
        elif name == "bias" and "bn" in parent:
            value = rng.normal(0.0, 0.1, shape)
        elif name in ("scale", "weight"):
            value = 1.0 + rng.normal(0.0, 0.05, shape)
        else:
            value = rng.normal(0.0, 0.02, shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(0)
    batches = _batches(rng)
    model = _jax_model()
    params = _random_params(model, batches[0], rng)
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
    return dict(model=model, params=params, batches=batches, losses=losses,
                final=jax.tree_util.tree_map(np.asarray, p))


def _port_optimizer(model, steps=STEPS, warmup=WARMUP):
    return build_optimizer(model, OptimizerConfig(**OPT_KW),
                           LRSchedulerConfig(num_warmup_steps=warmup), steps,
                           frozen_modules=model.frozen_modules())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_train_steps_match_jax(jax_run, use_kernels):
    model = _port_model(jax_run["params"], use_kernels)
    assert model.vision_model.fused_stages == ((0, 1) if use_kernels else ())
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler, _, trainable = _port_optimizer(model)
    step = make_train_step(model, optimizer, scheduler, trainable, 1.0)
    losses = [float(step(_torch_batch(b))[0]) for b in jax_run["batches"]]

    np.testing.assert_allclose(losses, jax_run["losses"], rtol=3e-4,
                               atol=3e-4)
    assert losses[0] != losses[-1]
    labels = label_params(model, frozen_modules=model.frozen_modules())
    want = state_dict_from_jax(jax_run["final"], "resnet50", BLOCKS,
                               T5_KW["num_layers"])
    got = model.state_dict()
    trained = [n for n, lab in labels.items() if lab != FROZEN_LABEL]
    assert len(trained) > 50
    for name in trained:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=name)
        assert not torch.equal(got[name], initial[name]), name
    frozen = [k for k in got if k.startswith("vision_model.")
              or k.startswith("upscale_layer.")]
    assert "vision_model.fc.weight" in frozen
    for name in frozen:
        assert torch.equal(got[name], initial[name]), name


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_jax_and_drives_the_optimizer(jax_run, warmup):
    total = 12
    for lr in (1.0, 5e-3):
        ours = linear_schedule_with_warmup(lr, warmup, total)
        theirs = jax_schedule(lr, warmup, total)
        for s in range(total + 2):
            assert ours(s) == pytest.approx(float(theirs(s)), rel=1e-6,
                                            abs=1e-12), (lr, s)
    if warmup:
        assert ours(0) == 0.0
    else:
        assert ours(0) == 5e-3

    model = _port_model(jax_run["params"])
    optimizer, scheduler, schedules, _ = _port_optimizer(model, total,
                                                         warmup)
    for s in range(total):
        for group in optimizer.param_groups:
            assert group["lr"] == pytest.approx(
                schedules[group["group"]](s), rel=1e-12, abs=1e-15)
        optimizer.step()
        scheduler.step()


def test_groups_match_jax_labels(jax_run):
    model = _port_model(jax_run["params"])
    frozen = model.frozen_modules()
    ours = label_params(model, frozen_modules=frozen)
    theirs = jax_labels(jax_run["params"], frozen_modules=frozen)
    unused = set(unused_parameters(model))
    assert unused == {n for n in ours if n.startswith("upscale_layer.")
                      or n.startswith("vision_model.fc.")}
    for top, subtree in theirs.items():
        want = set(jax.tree_util.tree_leaves(subtree))
        got = {lab for n, lab in ours.items()
               if n.split(".")[0] == top and n not in unused}
        assert got == want, top
    assert {n.split(".")[0] for n in ours} - set(theirs) == {"upscale_layer"}

    optimizer, _, _, trainable = _port_optimizer(model)
    lrs = {"vision": 8e-3, "lm_encoder": 1e-3, "fusion": 5e-4,
           "classifier": 1e-2}
    named = dict(model.named_parameters())
    for group in optimizer.param_groups:
        assert group["initial_lr"] == lrs[group["group"]]
        assert {n for n, p in named.items()
                if any(p is q for q in group["params"])} == {
            n for n, lab in ours.items() if lab == group["group"]}
    assert len(trainable) == sum(lab != FROZEN_LABEL for lab in ours.values())


def test_fine_tuned_tower_gets_every_gradient_and_matches_jax(jax_run):
    batch = jax_run["batches"][0]
    model = _port_model(jax_run["params"], use_kernels=True,
                        fine_tune_vision=True)
    assert model.frozen_modules() == ()
    _, loss = model(**_torch_batch(batch))
    loss.backward()
    vision = dict(model.vision_model.named_parameters())
    missing = [n for n, p in vision.items()
               if p.grad is None and not n.startswith("fc.")]
    assert missing == []
    assert all(float(p.grad.abs().max()) > 0 for n, p in vision.items()
               if not n.startswith("fc."))

    jmodel = _jax_model(fine_tune_vision=True)

    def loss_fn(p):
        return jmodel.apply({"params": p}, **batch)[1]

    grads = jax.jit(jax.grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jax_run["params"]))
    gv = grads["vision_model"]
    for torch_name, jax_tree in (("conv1", gv["conv1"]),
                                 ("layer1.0.conv1", gv["layer1_block0"]["conv1"]),
                                 ("layer3.0.conv1", gv["layer3_block0"]["conv1"])):
        want = np.asarray(jax_tree["kernel"]).transpose(3, 2, 0, 1)
        got = vision[f"{torch_name}.weight"].grad.numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, (torch_name, err)


def test_fused_stage_refuses_to_drop_a_gradient():
    backbone = ResNetBackbone("resnet50", use_kernel=True)
    x = torch.rand(1, 3, 32, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        backbone(x)
    with torch.no_grad():
        assert backbone(x)[-1].shape == (1, 2048, 1, 1)
    block = backbone.layer1[0]
    h = torch.rand(1, 8, 8, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.fused_bottleneck_packed(h, block.fused)
    with pytest.raises(RuntimeError, match="no backward"):
        K.fused_bottleneck(h, *block.fused_operands(torch.float32))


def test_fine_tuned_batchnorm_affine_trains_as_jax():
    rng = np.random.default_rng(1)
    batches = _batches(rng)[:2]
    lr = 2e-4
    opt_kw = {**OPT_KW, "vision_lr": lr}
    jmodel = _jax_model(fine_tune_vision=True, variant="resnet18")
    params = _random_params(jmodel, batches[0], rng)
    tx, _, _ = jax_build(JaxOptCfg(**opt_kw), JaxSchedCfg(num_warmup_steps=0),
                         len(batches), gradient_clipping=1.0,
                         frozen_modules=jmodel.frozen_modules())
    step = jax.jit(jax_step(jmodel, tx))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for batch in batches:
        p, state, _, _ = step(p, state, batch, jax.random.PRNGKey(1))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p),
                               "resnet18", BLOCKS, T5_KW["num_layers"])

    model = ResnetVQAModel(ANSWERS, vision_model_name="resnet18",
                           t5_config=T5Config(**T5_KW),
                           num_attention_blocks=BLOCKS,
                           sga_config=AttentionConfig(**SGA_KW),
                           fine_tune_vision=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, "resnet18", BLOCKS,
                                              T5_KW["num_layers"]),
                          strict=True)
    model.train()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler, _, trainable = build_optimizer(
        model, OptimizerConfig(**opt_kw),
        LRSchedulerConfig(num_warmup_steps=0), len(batches),
        frozen_modules=model.frozen_modules())
    port_step = make_train_step(model, optimizer, scheduler, trainable, 1.0)
    params_by_name = dict(model.named_parameters())
    first_moments = []
    for batch in batches:
        port_step(_torch_batch(batch))
        first_moments.append({
            n: optimizer.state[p]["exp_avg"].clone()
            for n, p in params_by_name.items() if p in optimizer.state})

    got = model.state_dict()
    affine = [k for k in got if k.startswith("vision_model.")
              and (".bn" in k or "downsample.1" in k)
              and k.rsplit(".", 1)[1] in ("weight", "bias")]
    assert len(affine) == 2 * 20                    # 20 BatchNorms
    eps = optimizer.param_groups[0]["eps"]
    beta1 = optimizer.param_groups[0]["betas"][0]
    near_zero = 0
    for name in affine:
        assert not torch.equal(got[name], initial[name]), name
        m1, m2 = first_moments[0][name], first_moments[1][name]
        # the clipped gradients AdamW saw at the two steps
        g1 = m1 / (1 - beta1)
        g2 = (m2 - beta1 * m1) / (1 - beta1)
        noisy = (torch.minimum(g1.abs(), g2.abs()) < 2 * eps).numpy()
        near_zero += int(noisy.sum())
        ours = (got[name] - initial[name]).numpy()
        theirs = want[name].numpy() - initial[name].numpy()
        gap = np.abs(ours - theirs)
        assert gap[~noisy].max() <= 0.1 * lr, (name, gap[~noisy].max() / lr)
        assert gap[noisy].max(initial=0.0) <= 0.25 * lr, (
            name, gap[noisy].max() / lr)
        # the schedule's 2 steps take lr, then lr / 2: a move past 1.2 lr
        # went the same way in both
        steady = np.abs(theirs) > 1.2 * lr
        assert steady.any(), name
        assert (np.sign(ours[steady]) == np.sign(theirs[steady])).all(), name
    # most elements are held to the tight bound
    assert near_zero < 2 * sum(got[n].numel() for n in affine) // 3
