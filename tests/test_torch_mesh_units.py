"""The mesh's parts against the JAX package's, on spawned gloo ranks.

* ``param_partition_spec`` of every parameter of the four families against
  JAX's spec of the leaf it stands for (named through the weight bridge:
  each JAX leaf is filled with its own index), transposed for an
  ``nn.Linear`` weight. ``relative_attention_bias`` is replicated, as in
  JAX: each rank reads its heads' columns of the whole table.
* ``make_mesh``: JAX's grid order (rank = d * tp + m), the groups, -1, a
  mesh smaller than the world, JAX's errors; a batch that does not divide
  over the data axis raises; the gather is exact to the bit; bf16 sums are
  taken in fp32.
* Lamb and Adafactor at tp=2 against tp=1 (3 steps with the clip on a
  repeated batch; Adafactor factors from dimension 16 so that T5's
  [64, 32] ``wi`` is factored on (32, 64), where its local [32, 32] slice
  would pick the other order): losses within 1e-5 relative, weights and optimizer
  state (gathered) within rtol 1e-4 / atol 1e-6 (fp32 sums in another
  order; one Lamb or Adafactor step moves an element by ~1e-4), but for
  the attention pooler's and the key projections' biases, whose gradient
  is zero but for rounding.
* Production dropout (T5 0.1, SGA 0.1) on the 2x2 mesh for 3 steps: every
  replicated parameter is the same to the bit on all four ranks, every
  split one on the two ranks of its data axis, and the losses are the
  single-device run's within 1e-5 relative (each rank keeps its block of
  the full masks, drawn as the CPU's ``F.dropout`` draws them).
* ``MeshDropout`` keeps, for backward, only its rank's block of the full
  mask, in storage of its own.
* The host-resident feature cache's cap counts the copies of the ranks on
  the host.
"""

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.parallel import param_partition_spec as jax_spec
from t5_resnet_vqa_torch.parallel import launch, param_partition_spec
from t5_resnet_vqa_torch.parallel.sharding import MODEL_AXIS
from t5_resnet_vqa_torch.train.optimizer import _factored_dims

import test_torch_mesh_train as base
import test_torch_mesh_workers as W

# the pooler's bias and an attention's key bias shift every score of a
# softmax row alike: their gradient is 0 but for rounding, whose sign
# Lamb's trust ratio and Adafactor's normalised update turn into a full
# step either way
SHIFT_INVARIANT = ("attention_pooler.attention.0.bias", "linear_k.bias")
CNN_KW = dict(answers=7, vision_model_name="resnet18", num_attention_blocks=1,
              t5=dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                      num_layers=2, num_heads=4, dropout_rate=0.0),
              sga=dict(hidden_size=32, num_heads=4, ff_size=32,
                       dropout_rate=0.0), seed=0)


def _cnn_batch(rng, b=4):
    mask = np.ones((b, 16), np.int32)
    mask[0, 10:] = 0
    return dict(question_input_ids=rng.integers(2, 64, (b, 16)).astype(
        np.int32) * mask, question_attention_masks=mask,
        image_tensors=rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8),
        annotation_ids=rng.integers(0, 7, b).astype(np.int32))


@pytest.mark.parametrize("family", ["cnn", "faster_rcnn", "vit", "cross"])
def test_partition_specs_match_jax(family):
    model, batches, kw, bridge = base.family_case(
        family, np.random.default_rng(0))
    feed = {k: v for k, v in batches[0].items() if k != "annotation_ids"}
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), **feed))["params"]
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    specs = [tuple(jax_spec(path, leaf)) for path, leaf in flat]
    coded = jax.tree_util.tree_unflatten(
        tree, [np.full(leaf.shape, i, np.float32)
               for i, (_, leaf) in enumerate(flat)])
    port = W.build_model(family, kw)
    named = dict(port.named_parameters())
    split = 0
    for key, t in bridge(coded).items():
        if key not in named:
            continue                   # buffers the bridge makes up
        values = set(t.flatten().tolist())
        assert len(values) == 1, key
        want = specs[int(values.pop())]
        if t.dim() == 2 and key.endswith(".weight"):
            want = tuple(reversed(want))     # [in, out] -> [out, in]
        got = param_partition_spec(key, named[key])
        assert got == want, (key, got, want)
        split += MODEL_AXIS in got
    assert split >= 10
    assert all(param_partition_spec(k, p) == ()
               for k, p in named.items() if "relative_attention_bias" in k)


def test_mesh_rules(tmp_path):
    out = launch.spawn(W.mesh_rules, 4, store_dir=str(tmp_path))
    assert [o["place"] for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [o["rows"] for o in out] == [(0, 4), (0, 4), (4, 8), (4, 8)]
    assert [o["tp_peers"] for o in out] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [o["dp_peers"] for o in out] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert out[0]["minus_one"] == {"data": 2, "model": 2}
    assert [o["small_member"] for o in out] == [True, True, False, False]
    errors = out[0]["errors"]
    assert errors[0] == "4 devices not divisible by model axis 3"
    assert "cannot reshape 4 devices" in errors[1]
    assert len(errors) == 3
    assert "data axis" in out[0]["rows_error"]
    for o in out[:2]:     # ranks 0 and 1 gathered rows [0, 1] in order
        assert o["gather_bits"] == out[0]["part_bits"] + out[1]["part_bits"]
    assert out[0]["gather_bits"][0][0] == np.float32(-0.0).view(np.int32)
    # 1 + 3 * 2^-8 in fp32, rounded once to bf16 (a bf16 sum gives 1)
    want = float(torch.tensor(1 + 3 * 2 ** -8).to(torch.bfloat16))
    assert want > 1.0
    assert all(o["bf16_sum"] == want for o in out)
    assert all(o["bf16_dtype"] == "torch.bfloat16" for o in out)
    assert all(o["object"] == {"rank": 0} for o in out)


@pytest.fixture(scope="module")
def cnn_spec():
    model = W.build_model("cnn", CNN_KW)
    return dict(family="cnn", model=CNN_KW, state=model.state_dict())


@pytest.mark.parametrize("opt_type", ["Lamb", "Adafactor"])
def test_lamb_and_adafactor_at_tp2_match_tp1(cnn_spec, opt_type, tmp_path):
    spec = dict(cnn_spec, type=opt_type, min_dim=16, steps=3,
                batch=_cnn_batch(np.random.default_rng(1)))
    one, two = launch.spawn(W.optimizer_steps, 2,
                            (spec, [(1, 1), (1, 2)]),
                            store_dir=str(tmp_path))[0]
    assert one["losses"][-1] < one["losses"][0]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for name, value in one["state"].items():
        if name.endswith(SHIFT_INVARIANT):
            continue
        np.testing.assert_allclose(two["state"][name], value, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert set(two["opt"]) == set(one["opt"])
    for key, value in one["opt"].items():
        if key.split("/")[0].endswith(SHIFT_INVARIANT):
            continue
        np.testing.assert_allclose(two["opt"][key], value, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    if opt_type == "Adafactor":
        # split weights are factored as their full shape says, though
        # their local slices would factor on the other dimensions
        swapped = [n for n in two["factored_split"]
                   if _factored_dims(one["state"][n].shape, 16)
                   != _factored_dims(
                       _local_shape(n, one["state"][n].shape), 16)]
        assert any(".wi." in n for n in swapped)


def _local_shape(name, shape):
    dim = 0 if name.split(".")[-2] in ("wi", "q", "k", "v") else 1
    shape = list(shape)
    shape[dim] //= 2
    return tuple(shape)


def test_dropout_keeps_replicas_identical(cnn_spec, tmp_path):
    rng = np.random.default_rng(2)
    kw = dict(CNN_KW, t5=dict(CNN_KW["t5"], dropout_rate=0.1),
              sga=dict(CNN_KW["sga"], dropout_rate=0.1))
    spec = dict(family="cnn", model=kw, state=cnn_spec["state"],
                batches=[_cnn_batch(rng) for _ in range(3)], warmup=1,
                optimizer=base.OPT_KW)
    ranks = launch.spawn(W.local_params_after_steps, 4, (spec, (2, 2)),
                         store_dir=str(tmp_path))
    split = ranks[0]["split"]
    assert len(split) >= 10
    first = ranks[0]["params"]
    for r in ranks[1:]:
        for name in set(first) - split:
            assert r["params"][name] == first[name], name
    for a, b in ((0, 2), (1, 3)):        # the same model index
        for name in split:
            assert ranks[a]["params"][name] == ranks[b]["params"][name]
    np.testing.assert_allclose(ranks[0]["losses"], _one_device_losses(spec),
                               rtol=1e-5)
    undropped = _one_device_losses(dict(spec, model=CNN_KW))
    assert max(abs(a - b) for a, b in zip(ranks[0]["losses"], undropped)) \
        > 1e-3


def _one_device_losses(spec):
    """The spec's steps on one device, without a mesh."""
    from t5_resnet_vqa_torch.core.config import (
        Config,
        LRSchedulerConfig,
        OptimizerConfig,
    )
    from t5_resnet_vqa_torch.train.trainer import setup_train_step

    torch.manual_seed(0)
    model = W.build_model("cnn", spec["model"])
    model.load_state_dict(spec["state"])
    model.train()
    config = Config(
        optimizer=OptimizerConfig(**spec["optimizer"]),
        lr_scheduler=LRSchedulerConfig(num_warmup_steps=spec["warmup"]))
    _, _, _, step = setup_train_step(model, config, len(spec["batches"]))
    return [float(step({k: torch.from_numpy(v) for k, v in b.items()})[0])
            for b in spec["batches"]]


def test_mesh_dropout_saves_only_its_block():
    from t5_resnet_vqa_torch.parallel.sharding import Mesh
    from t5_resnet_vqa_torch.parallel.tensor_parallel import MeshDropout

    # rank 3 of a 2x2 mesh: rows 2-3 of the global batch, columns 4-7
    drop = MeshDropout(0.1, Mesh(2, 2, 3, torch.device("cpu")), dim=1)
    x = torch.ones(2, 4, requires_grad=True)
    torch.manual_seed(0)
    y = drop(x)
    torch.manual_seed(0)
    full = torch.empty(4, 8).bernoulli_(0.9)
    torch.testing.assert_close(y, full[2:, 4:] / 0.9, rtol=0, atol=0)
    saved = y.grad_fn._saved_other
    assert saved.untyped_storage().nbytes() == x.numel() * x.element_size()


def test_host_cache_cap_counts_the_ranks_on_the_host():
    from t5_resnet_vqa_torch.data import Annotation, Question, Sample
    from t5_resnet_vqa_torch.train import build_feature_cache

    class Tower(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def compute_vision_features(self, images):
            return images.float().mean((1, 2)) * self.w    # [B, 3] fp32

    ds = [Sample(Question("q", f"q{i}", f"img{i}"),
                 Annotation(f"q{i}", f"img{i}", ["a"]), f"img{i}")
          for i in range(4)]
    load = lambda paths: np.zeros((len(paths), 2, 2, 3), np.uint8)
    size = 4 * 3 * 4                               # images x width x fp32
    built, why = build_feature_cache(Tower(), [ds], load, batch_size=2,
                                     max_bytes=2 * size, host_resident=True,
                                     host_ranks=2)
    assert built is not None and why is None
    assert built[0].features.device.type == "cpu"
    built, why = build_feature_cache(Tower(), [ds], load, batch_size=2,
                                     max_bytes=2 * size, host_resident=True,
                                     host_ranks=3)
    assert built is None and "x 3 ranks on this host" in why
