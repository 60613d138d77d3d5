"""Heatmaps and the test-set WUPS evaluation of the port against the JAX
package's ``viz/heatmap.py``.

* The numpy forms (``compute_cam``, ``attention_rollout``,
  ``rollout_mask``, ``overlay_cam``, ``overlay_rollout``) equal JAX's
  exactly on seeded inputs; the device forms (``compute_cam_batch``,
  ``rollout_mask_batch``) equal the numpy ones per sample within 1e-6
  (fp32). The overlays raise a clear ``ImportError`` without cv2, and the
  device step does not need it.
* ``generate_heatmaps`` end to end, on synthetic DAQUAR (6 test questions
  in batches of 4, the last padded; 80x48 source images), top 3, for the
  tiny CNN (ResNet-18, ``cam`` on C5), Faster-RCNN (``cam`` on the FPN's
  ``pool`` level) and ViT (2 layers, ``rollout``) models, from the same
  params in both packages: the port's device step (``make_infer_fn``)
  against JAX's harness fed by ``model.apply`` as its heatmap CLI feeds it.
  The same directory tree, equal ``predictions.json`` files, PNGs equal
  (the originals) or within one uint8 step of the heat value that the JET
  colour map reads (the overlays: at most ``JET_STEP`` in a channel), the
  same average WUPS. An ``infer_fn`` returning JAX's outputs (the raw
  feature map) gives the files of the device step's.
* ``python -m t5_resnet_vqa_torch.viz`` on ``device=cpu`` from a
  checkpoint gives the same files as JAX's harness; the cross-attention
  family is refused, and without ``device=cpu`` the CLI raises where no
  card exists.
"""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.data import DaquarCnnCollate as JaxCnnCollate
from t5_resnet_vqa_tpu.data import DaquarDataset as JaxDataset
from t5_resnet_vqa_tpu.data import DaquarVitCollate as JaxVitCollate
from t5_resnet_vqa_tpu.data import DataLoader as JaxLoader
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.models.vit_vqa import VitVQAModel as JaxVitModel
from t5_resnet_vqa_tpu.viz import heatmap as jax_viz
from t5_resnet_vqa_torch.data import (
    DaquarCnnCollate,
    DaquarDataset,
    DaquarVitCollate,
    DataLoader,
    load_answer_spaces,
)
from t5_resnet_vqa_torch.models import T5Config, ViTConfig, VitVQAModel
from t5_resnet_vqa_torch.train import factory
from t5_resnet_vqa_torch.utils import vit_state_dict_from_jax
from t5_resnet_vqa_torch.viz import heatmap as viz
from t5_resnet_vqa_torch.viz.__main__ import main as viz_main

import test_torch_family_trainer as family_case
import test_torch_trainer as cnn_case
import test_torch_vit_trainer as vit_case
from test_torch_resume import _jax_model_and_params

torch.set_num_threads(4)

TOP_K = 3
DEVICE_TOL = 1e-6
FAMILIES = ("cnn", "faster_rcnn", "vit")
MODE = {"cnn": "cam", "faster_rcnn": "cam", "vit": "rollout"}
VIT_LAYERS = 2
# one uint8 step of the heat value the colour map reads moves a JET colour
# by at most this much in a channel (the CAM overlay scales it by 0.9)
JET_STEP = int(np.abs(np.diff(cv2.applyColorMap(
    np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    .astype(np.int16), axis=0)).max())


# --------------------------------------------------------------- the math

def _softmaxed(rng, *shape):
    x = rng.normal(0.0, 2.0, shape).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_numpy_forms_equal_jax():
    rng = np.random.default_rng(0)
    features = rng.normal(size=(7, 9, 16)).astype(np.float32)
    for f in (features, np.ones_like(features)):      # and a flat map
        np.testing.assert_array_equal(viz.compute_cam(f),
                                      jax_viz.compute_cam(f))
    att = _softmaxed(rng, 3, 4, 17, 17)
    np.testing.assert_array_equal(viz.attention_rollout(att),
                                  jax_viz.attention_rollout(att))
    mask = viz.rollout_mask(att)
    assert mask.shape == (4, 4)
    np.testing.assert_array_equal(mask, jax_viz.rollout_mask(att))
    image = rng.integers(0, 256, (50, 70, 3), np.uint8)
    np.testing.assert_array_equal(
        viz.overlay_cam(image, viz.compute_cam(features)),
        jax_viz.overlay_cam(image, jax_viz.compute_cam(features)))
    np.testing.assert_array_equal(viz.overlay_rollout(image, mask),
                                  jax_viz.overlay_rollout(image, mask))


def test_device_forms_equal_numpy():
    rng = np.random.default_rng(1)
    features = rng.normal(size=(5, 6, 6, 24)).astype(np.float32)
    features[2] = 0.5                                  # a flat map
    cams = viz.compute_cam_batch(torch.from_numpy(features)).numpy()
    assert cams.shape == (5, 6, 6) and cams.dtype == np.float32
    for b in range(5):
        np.testing.assert_allclose(cams[b], viz.compute_cam(features[b]),
                                   rtol=0, atol=DEVICE_TOL)
    att = _softmaxed(rng, 4, 3, 2, 26, 26)            # [L, B, H, S, S]
    masks = viz.rollout_mask_batch(torch.from_numpy(att)).numpy()
    assert masks.shape == (3, 5, 5)
    for b in range(3):
        np.testing.assert_allclose(masks[b], viz.rollout_mask(att[:, b]),
                                   rtol=0, atol=DEVICE_TOL)


def test_overlays_need_cv2_and_the_device_step_does_not(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        viz.overlay_cam(np.zeros((4, 4, 3), np.uint8), np.zeros((2, 2)))
    with pytest.raises(ImportError, match="OpenCV"):
        viz.generate_heatmaps(lambda b: b, [], ["a"], "/nonexistent")
    cams = viz.compute_cam_batch(torch.ones(1, 2, 2, 3))
    assert cams.shape == (1, 2, 2)


# ------------------------------------------------------------ end to end

def _models(family, n):
    """(JAX model, its params, the port model on the same weights)."""
    if family == "cnn":
        jmodel, params = _jax_model_and_params("cnn", n)
        return jmodel, params, cnn_case._port_model(n, params)
    if family == "faster_rcnn":
        jmodel = family_case._jax_model("faster_rcnn", n)
        params = family_case._jax_params("faster_rcnn", jmodel)
        return jmodel, params, family_case._port_model("faster_rcnn", n,
                                                       params)
    vit_kw = dict(vit_case.VIT_KW, num_layers=VIT_LAYERS)
    jmodel = JaxVitModel(answer_spaces=n,
                         t5_config=JaxT5Config(**vit_case.T5_KW),
                         vit_config=JaxViTConfig(**vit_kw),
                         fusing_dropout=0.0)
    ids = np.ones((2, 16), np.int32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), question_input_ids=ids,
        question_attention_masks=ids,
        decoder_question_input_ids=np.ones((2, 20), np.int32),
        decoder_question_attention_masks=np.ones((2, 20), np.int32),
        pixel_values=np.zeros((2, 224, 224, 3), np.uint8))["params"])
    model = VitVQAModel(n, t5_config=T5Config(**vit_case.T5_KW),
                        vit_config=ViTConfig(**vit_kw), fusing_dropout=0.0,
                        device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params, VIT_LAYERS, 1),
                          strict=True)
    return jmodel, params, model


def _jax_infer(jmodel, params, mode):
    """JAX's heatmap CLI's ``_infer`` (CNN_vqa_heatmap.py)."""
    if mode == "cam":
        @jax.jit
        def infer(batch):
            log_probs, _, features = jmodel.apply(
                {"params": params}, **batch, deterministic=True,
                return_features=True)
            fmap = features["pool"] if "pool" in features \
                else features["features"]
            return {"log_probs": log_probs, "features": fmap}
    else:
        @jax.jit
        def infer(batch):
            log_probs, _, attentions = jmodel.apply(
                {"params": params}, **batch, deterministic=True,
                return_attentions=True)
            return {"log_probs": log_probs, "attentions": attentions}
    return infer


def _collate(pkg, family, answers):
    cnn, vit = ((DaquarCnnCollate, DaquarVitCollate) if pkg == "port"
                else (JaxCnnCollate, JaxVitCollate))
    if family == "vit":
        return vit(answers, eval_mode=True, emit_uint8=True)
    return cnn(answers, "bilinear_interpolation", (64, 64), eval_mode=True,
               emit_uint8=True)


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(base, n), root)] = \
                os.path.join(base, n)
    return out


def _assert_same_outputs(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert sorted(got) == sorted(want)
    assert len(want) == 6 * 3
    for rel, path in want.items():
        if rel.endswith(".json"):
            with open(got[rel]) as f, open(path) as g:
                assert json.load(f) == json.load(g), rel
        else:
            a = cv2.imread(got[rel]).astype(np.int16)
            b = cv2.imread(path).astype(np.int16)
            assert a.shape == b.shape, rel
            limit = (0 if os.path.basename(rel).startswith("original")
                     else JET_STEP)
            assert np.abs(a - b).max() <= limit, rel


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=4,
                                     num_test=6, image_size=64,
                                     source_hw=(48, 80))
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    return dict(tmp=tmp, root=root, kw=kw, answers=answers)


@pytest.fixture(scope="module")
def runs(data):
    """family -> both harnesses' run (made on first use)."""
    done = {}

    def get(family):
        if family not in done:
            done[family] = _run(data, family)
        return done[family]
    return get


def _run(data, family):
    mode = MODE[family]
    root, kw, answers = data["root"], data["kw"], data["answers"]
    jmodel, params, model = _models(family, len(answers))
    out = data["tmp"] / family
    jax_loader = JaxLoader(JaxDataset(root, kw["test_csv_file"],
                                      kw["images_dir"], "test"),
                           _collate("jax", family, answers), 4,
                           drop_remainder=False)
    want = jax_viz.generate_heatmaps(_jax_infer(jmodel, params, mode),
                                     jax_loader, answers, str(out / "jax"),
                                     mode=mode, top_k=TOP_K)
    loader = DataLoader(DaquarDataset(root, kw["test_csv_file"],
                                      kw["images_dir"], "test"),
                        _collate("port", family, answers), 4,
                        drop_remainder=False)
    got = viz.generate_heatmaps(viz.make_infer_fn(model, mode, TOP_K),
                                loader, answers, str(out / "port"),
                                mode=mode, top_k=TOP_K)
    return dict(model=model, out=out, want=want, got=got)


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_heatmaps_matches_jax(runs, family):
    run = runs(family)
    assert run["got"] == run["want"]
    _assert_same_outputs(run["out"] / "port", run["out"] / "jax")


def test_generate_heatmaps_takes_jax_outputs(runs, data, tmp_path):
    """An ``infer_fn`` that returns JAX's outputs (log-probs and the raw
    feature map) gives the files of the device step's reduced ones."""
    run = runs("cnn")
    model, answers, root, kw = (run["model"].eval(), data["answers"],
                                data["root"], data["kw"])

    def infer(batch):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.inference_mode():
            features = model.compute_vision_features(
                batch.pop("image_tensors"))
            log_probs = model(**batch, vision_features=features)[0]
        return {"log_probs": log_probs.numpy(), "features": features.numpy()}

    loader = DataLoader(DaquarDataset(root, kw["test_csv_file"],
                                      kw["images_dir"], "test"),
                        _collate("port", "cnn", answers), 4,
                        drop_remainder=False)
    got = viz.generate_heatmaps(infer, loader, answers, str(tmp_path),
                                mode="cam", top_k=TOP_K)
    assert got == run["got"]
    _assert_same_outputs(tmp_path, run["out"] / "port")


def test_cam_forward_computes_the_pool_level_alone(data, monkeypatch):
    model = family_case._port_model("faster_rcnn", len(data["answers"]))
    levels_asked = []
    real = type(model)._levels

    def levels(self, images, all_levels):
        levels_asked.append(all_levels)
        return real(self, images, all_levels)

    monkeypatch.setattr(type(model), "_levels", levels)
    batch = {"question_input_ids": torch.ones(2, 16, dtype=torch.int32),
             "question_attention_masks": torch.ones(2, 16, dtype=torch.int32),
             "image_tensors": torch.zeros(2, 64, 64, 3, dtype=torch.uint8)}
    with torch.inference_mode():
        out = viz.heatmap_step(model.eval(), batch, "cam", 2)
    assert levels_asked == [False]
    # 64^2 images: C5 is 2x2, its pool level 1x1
    assert out["maps"].shape == (2, 1, 1) and out["topk"].shape == (2, 2)


# -------------------------------------------------------------------- CLI

def _checkpoint(tmp, family, model, answers, out_name, **model_kw):
    """A port output directory holding ``model``'s best-model.pt and the
    answer space, and a config naming it."""
    out_dir = tmp / out_name
    ckpt = out_dir / "model_checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(model.state_dict(), str(ckpt / "best-model.pt"))
    with open(ckpt / "model_ckpt_info.json", "w") as f:
        json.dump({"answer_spaces": answers}, f)
    return out_dir


def _config(data, out_dir, model_kw, device="cpu"):
    raw = cnn_case._raw_config(data["root"], data["kw"], out_dir,
                               device=device)
    raw["model_kwargs"] = dict(model_kw)
    return cnn_case._write(out_dir, raw)


def test_cli_runs_on_the_cpu(runs, data, monkeypatch):
    run = runs("cnn")
    answers, model = data["answers"], run["model"]
    out_dir = _checkpoint(data["tmp"], "cnn", model, answers, "cli_cnn")
    monkeypatch.setattr(factory, "build_model",
                        lambda cfg, n, device=None, generator=None:
                        (cnn_case._port_model(n), "cnn"))
    path = _config(data, out_dir, {"vision_model_name": "resnet18"})
    avg = viz_main(["--mode", "cam", "--config", path, "--top-k",
                    str(TOP_K)])
    assert avg == run["want"]
    _assert_same_outputs(out_dir / "heatmaps", run["out"] / "jax")
    with pytest.raises(SystemExit, match="needs the 'vit' family"):
        viz_main(["--mode", "rollout", "--config", path])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viz_main(["--config", _config(data, out_dir,
                                      {"vision_model_name": "resnet18"},
                                      device="cuda")])


def test_cli_refuses_the_cross_attention_family(data, monkeypatch):
    answers = data["answers"]
    model = family_case._port_model("cross", len(answers))
    out_dir = _checkpoint(data["tmp"], "cross", model, answers, "cli_cross")
    monkeypatch.setattr(factory, "build_model",
                        lambda cfg, n, device=None, generator=None:
                        (family_case._port_model("cross", n),
                         "cross_attention"))
    path = _config(data, out_dir, family_case.MODEL_KW["cross"])
    for mode in ("cam", "rollout"):
        with pytest.raises(SystemExit, match="cross-attention family"):
            viz_main(["--mode", mode, "--config", path])
