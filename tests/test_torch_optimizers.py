"""The port's SGD, Lamb and Adafactor against the JAX package's
``build_optimizer`` (optax ``sgd``, ``lamb``, ``adafactor`` under
``multi_transform`` per LR group, after ``clip_by_global_norm``).

A small model whose top-level modules are named as the JAX groups are,
with the shapes that decide the optimizers' branches:

* ``classification_layer``: a [160, 192] weight (factored by Adafactor:
  its second-largest dimension is at least 128) and its 1-D bias;
* ``upscale_layer``: a ConvTranspose channel projection 128 -> 144 with a
  3x3 kernel (factored over its two channel dimensions; the JAX kernel is
  the flipped HWIO conv);
* ``sga_modules``: a [48, 64] weight (under 128: unfactored) and a
  LayerNorm (1-D);
* ``vision_model``: a frozen convolution, which no optimizer moves.

The JAX params are seeded with numpy and go through the port's weight
bridge; each step's gradients are seeded too, with a global norm well
above the clip, and take the same bridge. After 3 steps of each case every
trainable tensor is within 1e-6 relative (L2) of JAX's (and within 1e-2 of
the update JAX made to it), and the frozen one is unchanged. An optimizer
and scheduler ``state_dict`` saved after 2 steps and loaded into a fresh
optimizer takes the third step to the bit.
"""

import io

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from t5_resnet_vqa_tpu.core.config import LRSchedulerConfig as JaxSched
from t5_resnet_vqa_tpu.core.config import OptimizerConfig as JaxOpt
from t5_resnet_vqa_tpu.train.optimizer import build_optimizer as jax_build
from t5_resnet_vqa_torch.core.config import LRSchedulerConfig, OptimizerConfig
from t5_resnet_vqa_torch.ops.layers import ChannelProjection
from t5_resnet_vqa_torch.train.optimizer import (
    Adafactor,
    Lamb,
    SGD,
    build_optimizer,
)
from t5_resnet_vqa_torch.utils.weights import (
    export_conv2d,
    export_conv_as_conv_transpose2d,
    export_layernorm,
    export_linear,
)

CASES = {
    "sgd": ("SGD", {"momentum": 0.0}),
    "sgd_momentum": ("SGD", {"momentum": 0.9}),
    "lamb": ("Lamb", {"weight_decay": 0.0}),
    "lamb_wd": ("Lamb", {"weight_decay": 0.1}),
    "adafactor": ("Adafactor", {}),
}
PORT_CLASS = {"SGD": SGD, "Lamb": Lamb, "Adafactor": Adafactor}
STEPS = 3
TOTAL_STEPS = 10
TOL = 1e-6
FROZEN = ("vision_model",)


class _Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.classification_layer = nn.Linear(192, 160)
        self.upscale_layer = ChannelProjection(128, 144)
        self.sga_modules = nn.Sequential(nn.Linear(64, 48), nn.LayerNorm(48))
        self.vision_model = nn.Conv2d(3, 8, 3)


def _jax_tree(rng, scale=0.05):
    def normal(*shape):
        return (rng.normal(0.0, scale, shape)).astype(np.float32)
    return {
        "classification_layer": {"kernel": normal(192, 160),
                                 "bias": normal(160)},
        "upscale_layer": {"conv": {"kernel": normal(3, 3, 128, 144),
                                   "bias": normal(144)}},
        "sga_modules": {"dense": {"kernel": normal(64, 48),
                                  "bias": normal(48)},
                        "norm": {"scale": 1.0 + normal(48),
                                 "bias": normal(48)}},
        "vision_model": {"kernel": normal(3, 3, 3, 8), "bias": normal(8)},
    }


def _to_port(tree):
    """The weight bridge: a JAX-layout tree -> the model's state_dict."""
    out = {}
    export_linear(out, tree["classification_layer"], "classification_layer")
    export_conv_as_conv_transpose2d(out, tree["upscale_layer"]["conv"],
                                    "upscale_layer")
    export_linear(out, tree["sga_modules"]["dense"], "sga_modules.0")
    export_layernorm(out, tree["sga_modules"]["norm"], "sga_modules.1")
    export_conv2d(out, tree["vision_model"], "vision_model")
    return out


def _configs(pkg_opt, pkg_sched, case):
    opt_type, kwargs = CASES[case]
    opt = pkg_opt(type=opt_type, default_lr=1e-2, lm_encoder_lr=1e-2,
                  vision_lr=3e-2, classifier_lr=2e-2, fusion_lr=5e-3,
                  kwargs=dict(kwargs))
    return opt, pkg_sched(num_warmup_steps=1)


def _grads(seed):
    """Per-element 0.5: a global norm of ~90, far above the clip of 1; the
    frozen module's are zeros, as JAX's ``stop_gradient`` makes them."""
    grads = _jax_tree(np.random.default_rng(100 + seed), scale=0.5)
    grads["vision_model"] = jax.tree_util.tree_map(np.zeros_like,
                                                   grads["vision_model"])
    return grads


def _jax_run(case, params):
    opt, sched = _configs(JaxOpt, JaxSched, case)
    tx, _, _ = jax_build(opt, sched, TOTAL_STEPS, gradient_clipping=1.0,
                         frozen_modules=FROZEN)
    state = tx.init(params)
    for step in range(STEPS):
        updates, state = tx.update(_grads(step), state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_optimizer(case, model):
    opt, sched = _configs(OptimizerConfig, LRSchedulerConfig, case)
    return build_optimizer(model, opt, sched, TOTAL_STEPS,
                           frozen_modules=FROZEN)


def _port_step(model, optimizer, scheduler, trainable, step):
    grads = _to_port(_grads(step))
    for name, p in model.named_parameters():
        p.grad = None if name.startswith("vision_model") else \
            grads[name].clone()
    torch.nn.utils.clip_grad_norm_(trainable, 1.0)
    optimizer.step()
    scheduler.step()


def _start(case):
    params = _jax_tree(np.random.default_rng(0))
    model = _Model()
    model.load_state_dict(_to_port(params), strict=True)
    return params, model


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_optax(case):
    params, model = _start(case)
    optimizer, scheduler, _, trainable = _port_optimizer(case, model)
    assert type(optimizer) is PORT_CLASS[CASES[case][0]]
    for step in range(STEPS):
        _port_step(model, optimizer, scheduler, trainable, step)
    want = _to_port(_jax_run(case, params))
    start = _to_port(params)
    for name, got in model.state_dict().items():
        if name.startswith("vision_model"):
            assert torch.equal(got, start[name]), name
            continue
        err = float((got - want[name]).norm() / want[name].norm())
        assert err <= TOL, (name, err)
        # the tensor moved, by what JAX moved it: the difference is fp32
        # rounding of the parameter, far below the update
        moved = (want[name] - start[name]).norm()
        assert moved > 0, name
        assert float((got - want[name]).norm() / moved) <= 1e-2, name


def test_adafactor_state_is_factored_as_optax():
    params, model = _start("adafactor")
    optimizer, scheduler, _, trainable = _port_optimizer("adafactor", model)
    _port_step(model, optimizer, scheduler, trainable, 0)
    state = {name: optimizer.state[p]
             for name, p in model.named_parameters()
             if p in optimizer.state}
    assert set(state["classification_layer.weight"]) == {
        "step", "v_row", "v_col"}
    assert set(state["upscale_layer.weight"]) == {"step", "v_row", "v_col"}
    # [I=128, O=144, 3, 3]: row over the input channels, col over the output
    assert state["upscale_layer.weight"]["v_row"].shape == (128, 3, 3)
    assert state["upscale_layer.weight"]["v_col"].shape == (144, 3, 3)
    for name in ("sga_modules.0.weight", "sga_modules.1.weight",
                 "classification_layer.bias"):
        assert set(state[name]) == {"step", "v"}, name
    assert not any(n.startswith("vision_model") for n in state)
    assert all(float(s["step"]) == 1.0 for s in state.values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip_resumes_to_the_bit(case):
    params, model = _start(case)
    optimizer, scheduler, _, trainable = _port_optimizer(case, model)
    for step in range(STEPS - 1):
        _port_step(model, optimizer, scheduler, trainable, step)
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)

    resumed = _Model()
    resumed.load_state_dict(saved["model"], strict=True)
    optimizer2, scheduler2, _, trainable2 = _port_optimizer(case, resumed)
    optimizer2.load_state_dict(saved["optimizer"])
    scheduler2.load_state_dict(saved["scheduler"])
    _port_step(model, optimizer, scheduler, trainable, STEPS - 1)
    _port_step(resumed, optimizer2, scheduler2, trainable2, STEPS - 1)
    for (name, a), b in zip(model.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(a, b), name


def test_lamb_norms_are_accurate_on_a_large_tensor():
    """Lamb's trust ratio on a table of 8M elements: the fp32 step within
    1e-5 (L2, relative) of the same step in float64, as on the card.
    ``Tensor.norm`` of such an fp32 tensor on the CPU is off by ~1e-3."""
    torch.manual_seed(0)
    p = torch.randn(8192, 1024) * 0.05
    p[:64] += 1.0
    g = torch.randn(8192, 1024) * 1e-4
    updates = []
    for dtype in (torch.float32, torch.float64):
        q = p.to(dtype).clone()
        q.grad = g.to(dtype)
        Lamb([q], lr=1e-2, weight_decay=0.1).step()
        updates.append((q - p.to(dtype)).double())
    gap = float((updates[0] - updates[1]).norm() / updates[1].norm())
    assert gap <= 1e-5, gap
