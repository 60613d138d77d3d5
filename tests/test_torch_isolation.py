"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* An AST scan of every file of ``t5_resnet_vqa_torch/`` finds no import of
  jax, flax, optax, orbax or t5_resnet_vqa_tpu, at any depth.
* Packages the GPU machine lacks (cv2, PIL, pandas, transformers,
  tokenizers, triton, nltk) are imported only inside functions.
* Every module imports in a fresh interpreter in which ``import jax`` fails.
* Entry points raise when no CUDA device exists and the CPU was not named.
* A mesh (``parallel/``) larger than the visible cards raises instead of
  running on fewer ranks, in the launcher and in both entry points; the
  CPU runs one only when it is named.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import t5_resnet_vqa_torch
from t5_resnet_vqa_torch.core import resolve_device
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import (
    CrossAttentionVitVQAModel,
    FasterRcnnVQAModel,
    ResnetVQAModel,
    RobertaConfig,
    T5Config,
    ViTConfig,
    VitVQAModel,
)
from t5_resnet_vqa_torch.ops import AttentionConfig

PKG_DIR = os.path.dirname(t5_resnet_vqa_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "flax", "optax", "orbax", "t5_resnet_vqa_tpu")
LAZY_ONLY = ("cv2", "PIL", "pandas", "transformers", "tokenizers", "triton",
             "nltk")


def _sources():
    for root, _, files in os.walk(PKG_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    return []


SOURCES = sorted(_sources())


def test_package_has_sources():
    names = {os.path.relpath(p, PKG_DIR) for p in SOURCES}
    for rel in ("ops/attention.py", "ops/bottleneck.py", "ops/layers.py",
                "models/resnet_vqa.py", "models/vit.py",
                "models/vit_vqa.py", "models/generation.py", "eval/session.py",
                "utils/weights.py", "core/constants.py", "core/config.py",
                "data/pipeline.py", "eval/wups.py", "train/trainer.py",
                "train/optimizer.py", "train/__main__.py",
                "train/feature_cache.py", "train/vit.py",
                "train/callbacks.py", "eval/rouge.py", "utils/profiling.py",
                "native/loader.py", "models/fpn.py",
                "models/faster_rcnn_vqa.py", "models/roberta.py",
                "models/cross_attention_vqa.py", "data/answer_space.py",
                "data/okvqa.py", "viz/__init__.py", "viz/heatmap.py",
                "viz/__main__.py", "eval/http_server.py", "serve.py",
                "parallel/__init__.py", "parallel/sharding.py",
                "parallel/tensor_parallel.py", "parallel/launch.py",
                "data/daquar_vocab.py"):
        assert rel in names
    for cu in ("attention.cu", "bottleneck.cu"):
        assert os.path.exists(os.path.join(PKG_DIR, "csrc", cu))
    assert os.path.exists(os.path.join(PKG_DIR, "native", "preproc.cpp"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, PKG_DIR))
def test_no_jax_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        for name in _imported(node):
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, PKG_DIR))
def test_optional_packages_are_lazy(path):
    tree = ast.parse(open(path).read(), path)
    for node in tree.body:          # module level only
        for name in _imported(node):
            assert name.split(".")[0] not in LAZY_ONLY, \
                f"{path}:{node.lineno} imports {name} at module level"


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 't5_resnet_vqa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import t5_resnet_vqa_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_model(**kw):
    return ResnetVQAModel(
        5, vision_model_name="resnet18",
        t5_config=T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                           num_layers=1, num_heads=4),
        num_attention_blocks=1,
        sga_config=AttentionConfig(hidden_size=16, num_heads=4, ff_size=16),
        **kw)


def test_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_model_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_model()
    assert _tiny_model(device="cpu").classification_layer.weight.is_cpu


def test_session_raises_without_cuda(no_cuda):
    model = _tiny_model(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQAInferenceSession(model, None, ["a", "b", "c", "d", "e"])
    session = VQAInferenceSession(model, None, ["a", "b", "c", "d", "e"],
                                  device="cpu")
    assert session.device.type == "cpu"


def test_kernel_build_is_lazy():
    """Importing the wrappers builds nothing: the library path is only
    computed from the sources, and it changes when a source changes."""
    from t5_resnet_vqa_torch.ops import kernel_build

    path = kernel_build.library_path("attention")
    assert path.startswith(kernel_build.BUILD_DIR)
    assert os.path.basename(path).startswith("attention-")
    assert kernel_build.library_path("bottleneck") != path
    assert "attention" not in kernel_build._loaded


def test_kernel_error_codes_raise():
    from t5_resnet_vqa_torch.ops import kernel_build

    kernel_build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        kernel_build.check(98, "attention_forward")


def _tiny_vit_model(**kw):
    return VitVQAModel(5, t5_config=T5Config(vocab_size=64, d_model=32,
                                             d_kv=8, d_ff=32, num_layers=1,
                                             num_decoder_layers=1,
                                             num_heads=4),
                       vit_config=ViTConfig.tiny(), **kw)


def test_vit_model_and_session_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_vit_model()
    model = _tiny_vit_model(device="cpu")
    assert model.classification_layer.weight.is_cpu
    answers = ["a", "b", "c", "d", "e"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQAInferenceSession(model, None, answers, "vit")
    session = VQAInferenceSession(model, None, answers, "vit", device="cpu")
    assert session.device.type == "cpu"


def _tiny_frcnn_model(**kw):
    return FasterRcnnVQAModel(
        5, t5_config=T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                              num_layers=1, num_heads=4),
        num_attention_blocks=1,
        sga_config=AttentionConfig(hidden_size=16, num_heads=4, ff_size=16),
        fpn_channels=8, **kw)


def _tiny_cross_model(**kw):
    return CrossAttentionVitVQAModel(5, vit_config=ViTConfig.tiny(),
                                     roberta_config=RobertaConfig.tiny(),
                                     **kw)


@pytest.mark.parametrize("build,family", [(_tiny_frcnn_model, "cnn"),
                                          (_tiny_cross_model,
                                           "cross_attention")],
                         ids=["faster_rcnn", "cross_attention"])
def test_new_family_models_and_sessions_raise_without_cuda(no_cuda, build,
                                                           family):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(device=None)
    model = build(device="cpu")
    assert model.classification_layer.weight.is_cpu
    answers = ["a", "b", "c", "d", "e"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQAInferenceSession(model, None, answers, family)
    session = VQAInferenceSession(model, None, answers, family, device="cpu")
    assert session.device.type == "cpu"


def test_mesh_larger_than_the_cards_raises(monkeypatch):
    from t5_resnet_vqa_torch.parallel import launch

    assert launch.resolve_mesh_size(2, 2, "cpu") == 2
    with pytest.raises(ValueError, match="counts cards"):
        launch.resolve_mesh_size(-1, 1, "cpu")
    with pytest.raises(ValueError, match="only 0 available"):
        launch.resolve_mesh_size(2, 1, "cuda")       # no card here
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert launch.resolve_mesh_size(-1, 1, "cuda") == 3
    assert launch.resolve_mesh_size(1, 3, "cuda") == 1
    with pytest.raises(ValueError, match="only 3 available"):
        launch.resolve_mesh_size(2, 2, "cuda")
    with pytest.raises(ValueError, match="not divisible by model axis 2"):
        launch.resolve_mesh_size(-1, 2, "cuda")


@pytest.mark.parametrize("module", ["train", "serve"])
def test_mesh_entry_points_raise_without_cuda(no_cuda, module, tmp_path):
    """Without ``device=cpu`` a mesh needs cards: on a machine without one
    the entry points stop before anything loads or any rank starts."""
    import importlib
    import json

    path = tmp_path / "config.json"
    path.write_text(json.dumps({"trainer_kwargs": {"device": "cuda"}}))
    parse = importlib.import_module(
        f"t5_resnet_vqa_torch.{module}" + (".__main__" if module == "train"
                                            else "")).parse_args
    with pytest.raises(SystemExit):
        parse(["--config", str(path), "--data-parallel", "2"])
    path.write_text(json.dumps({"trainer_kwargs": {"device": "cpu"}}))
    assert parse(["--config", str(path), "--data-parallel", "2"])[-1] == \
        (2, 1)


def test_launcher_builds_nothing_at_import():
    """The launcher starts no process and no group at import; a rank's
    device is the one it was given."""
    import torch.distributed as dist

    from t5_resnet_vqa_torch.parallel import launch

    assert not dist.is_initialized()
    assert launch.current_device() == torch.device("cpu")
