"""``VQATrainer`` on a 2x2 (data, model) mesh against the mesh-free run, and
the checkpoint pair across the two (the counterparts of the JAX package's
``tests/test_trainer_mesh.py``).

The CNN family at small widths (ResNet-18 tower, T5 d_model 32 with one
layer, one SGA block; dropout 0) on synthetic DAQUAR (8 train questions in
batches of 4; 6 test questions, so that the last test batch is padded),
the frozen-feature cache on, from the same seeded weights:

* one epoch on the mesh (4 gloo ranks) against one epoch on one device:
  train and validation losses within 1e-5 relative, the same validation
  predictions; the log says ``Mesh: {'data': 2, 'model': 2}`` and that the
  cache is ``on host (mesh run)``; rank 0 alone wrote the records;
* the pair the mesh wrote has the one-device pair's layout (keys, shapes,
  dtypes of the weights and of the optimizer state) and values within
  rtol 5e-3 / atol 5e-4 (``test_torch_mesh_train.py``'s);
* resume: a one-device trainer resumes the mesh pair, and a mesh trainer
  the one-device pair; each runs epoch 1 with the losses of a one-device
  trainer resumed from the one-device pair, within 1e-5 relative.

``python -m t5_resnet_vqa_torch.train`` parses a mesh on the CPU and
refuses one it cannot make; its full-width run on a mesh (T5-base) is
marked slow, and so is a 2x2 run killed with SIGKILL (every rank, in the
middle of its periodic saves) and resumed to its end (the counterpart of
JAX's ``test_sigkill_mid_mesh_training_resumes``).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import load_answer_spaces, make_synthetic_daquar
from t5_resnet_vqa_torch.parallel import launch
from t5_resnet_vqa_torch.train import VQATrainer

import test_torch_mesh_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T5_KW = dict(vocab_size=32128, d_model=32, d_kv=8, d_ff=64, num_layers=1,
             num_decoder_layers=1, num_heads=4, dropout_rate=0.0)
SPEC = dict(family="cnn", model=dict(
    answers=None, vision_model_name="resnet18", num_attention_blocks=1,
    t5=T5_KW, sga=dict(hidden_size=32, num_heads=4, ff_size=32,
                       dropout_rate=0.0), seed=5))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=8,
                                     num_test=6, image_size=64,
                                     source_hw=(48, 80))
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    spec = dict(SPEC, model=dict(SPEC["model"], answers=len(answers)))
    return dict(tmp=tmp, root=root, kw=kw, answers=answers, spec=spec)


def _config(data, out_dir, epochs=1, resume=False):
    raw = {
        "model_kwargs": {"vision_model_name": "resnet18"},
        "dataset_kwargs": dict(data["kw"], root_data_dir=data["root"],
                               train_batch_size=4, test_batch_size=4,
                               image_size=64, use_native_preprocessor=False),
        "trainer_kwargs": dict(epochs=epochs, output_dir=str(out_dir),
                               seed=0, device="cpu",
                               cache_frozen_features=True,
                               load_from_checkpoint=resume,
                               first_val_epoch=0),
        "optimizer_kwargs": {"type": "AdamW", "lm_encoder_lr": 1e-3,
                             "classifier_lr": 5e-3, "fusion_lr": 1e-3,
                             "kwargs": {"weight_decay": 0.1,
                                        "amsgrad": True}},
        "lr_scheduler_kwargs": {"num_warmup_steps": 1},
        "callbacks_kwargs": {"kwargs": {"threshold": -1.0}},
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(str(out_dir), "..", os.path.basename(str(out_dir))
                        + ".json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _one_device(data, path):
    trainer = VQATrainer(W.build_model("cnn", data["spec"]["model"]),
                         Config.from_json(path), data["answers"])
    trainer.train()


def _mesh(data, path, tmp):
    launch.spawn(W.trainer_run, 4, (path, data["spec"], (2, 2)),
                 store_dir=str(tmp))


def _metrics(out_dir):
    records = [json.loads(line) for line in open(
        os.path.join(str(out_dir), "metrics.jsonl"))]
    return [r for r in records if r.get("_event") == "log"]


def _log(out_dir):
    name = next(f for f in os.listdir(str(out_dir))
                if f.startswith("training_log_"))
    return open(os.path.join(str(out_dir), name)).read()


def _losses(out_dir, epoch):
    rec = [r for r in _metrics(out_dir) if r["epoch"] == epoch]
    return ([r["train_avg_loss"] for r in rec if "train_avg_loss" in r]
            + [r["valid_avg_loss"] for r in rec if "valid_avg_loss" in r])


def _pair(out_dir):
    ck = os.path.join(str(out_dir), "model_checkpoints")
    return (torch.load(os.path.join(ck, "checkpoint-model.pt"),
                       weights_only=True),
            torch.load(os.path.join(ck, "state_dict_checkpoint.pt"),
                       weights_only=True))


@pytest.fixture(scope="module")
def runs(data):
    tmp = data["tmp"]
    one, mesh = tmp / "one", tmp / "mesh"
    _one_device(data, _config(data, one))
    _mesh(data, _config(data, mesh), tmp / "store_mesh")
    return dict(one=one, mesh=mesh)


def test_mesh_epoch_matches_one_device(runs):
    np.testing.assert_allclose(_losses(runs["mesh"], 0),
                               _losses(runs["one"], 0), rtol=1e-5)
    assert len(_losses(runs["one"], 0)) == 2
    preds = "validation_predictions/0_validation_predictions.json"
    got = json.load(open(os.path.join(str(runs["mesh"]), preds)))
    want = json.load(open(os.path.join(str(runs["one"]), preds)))
    assert [p["prediction"] for p in got] == [p["prediction"] for p in want]
    assert len(got) == 6
    log = _log(runs["mesh"])
    assert "Mesh: {'data': 2, 'model': 2}" in log
    assert "on host (mesh run)" in log
    assert "Mesh:" not in _log(runs["one"])
    # rank 0 alone logs
    assert sum(f.startswith("training_log_")
               for f in os.listdir(str(runs["mesh"]))) == 1


def test_mesh_pair_has_the_one_device_layout(runs):
    (m_params, m_state), (o_params, o_state) = (_pair(runs["mesh"]),
                                                _pair(runs["one"]))
    assert list(m_params) == list(o_params)
    for k, v in o_params.items():
        assert (m_params[k].shape, m_params[k].dtype) == (v.shape, v.dtype)
        np.testing.assert_allclose(m_params[k].numpy(), v.numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=k)
    assert (m_state["epoch"], m_state["global_step"]) == \
        (o_state["epoch"], o_state["global_step"]) == (1, 2)
    m_opt, o_opt = m_state["optimizer"], o_state["optimizer"]
    assert m_opt["param_groups"] == o_opt["param_groups"]
    assert sorted(m_opt["state"]) == sorted(o_opt["state"])
    for i, entries in o_opt["state"].items():
        assert sorted(m_opt["state"][i]) == sorted(entries)
        for key, v in entries.items():
            assert m_opt["state"][i][key].shape == v.shape, (i, key)
    assert m_state["scheduler"] == o_state["scheduler"]


def test_resume_across_mesh_and_one_device(runs, data):
    tmp = data["tmp"]
    dirs = {}
    for name, src in (("r_one", runs["one"]), ("r_mesh_pair", runs["mesh"]),
                      ("r_on_mesh", runs["one"])):
        dirs[name] = tmp / name
        shutil.copytree(str(src), str(dirs[name]))
    _one_device(data, _config(data, dirs["r_one"], epochs=2, resume=True))
    _one_device(data, _config(data, dirs["r_mesh_pair"], epochs=2,
                              resume=True))
    _mesh(data, _config(data, dirs["r_on_mesh"], epochs=2, resume=True),
          tmp / "store_resume")
    want = _losses(dirs["r_one"], 1)
    assert len(want) == 2
    for name in ("r_mesh_pair", "r_on_mesh"):
        np.testing.assert_allclose(_losses(dirs[name], 1), want, rtol=1e-5,
                                   err_msg=name)
        log = _log_latest(dirs[name])
        assert "Loaded params from checkpoint-model" in log
        assert "Loaded Optimizer from Checkpoint (epoch 1, step 2)" in log


def _log_latest(out_dir):
    names = sorted(f for f in os.listdir(str(out_dir))
                   if f.startswith("training_log_"))
    return open(os.path.join(str(out_dir), names[-1])).read()


def test_cli_parses_a_mesh_on_the_cpu(data, tmp_path, monkeypatch):
    from t5_resnet_vqa_torch.train.__main__ import parse_args
    path = _config(data, tmp_path / "cli")
    cfg, shape = parse_args(["--config", path, "--data-parallel", "2",
                             "--model-parallel", "2"])
    assert shape == (2, 2) and cfg.trainer.device == "cpu"
    assert parse_args(["--config", path])[1] is None
    for bad in (["--model-parallel", "2"], ["--data-parallel", "-1"],
                ["--data-parallel", "2", "--model-parallel", "0"]):
        with pytest.raises(SystemExit):
            parse_args(["--config", path, *bad])
    # on the card, a mesh larger than the visible cards is refused
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    raw = json.load(open(path))
    raw["trainer_kwargs"]["device"] = "cuda"
    with open(path, "w") as f:
        json.dump(raw, f)
    assert parse_args(["--config", path, "--data-parallel", "-1"])[1] == \
        (2, 1)
    with pytest.raises(SystemExit):
        parse_args(["--config", path, "--data-parallel", "2",
                    "--model-parallel", "2"])


def _cli(args):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "t5_resnet_vqa_torch.train", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200)


@pytest.mark.slow
def test_cli_trains_on_a_mesh_at_full_width(data, tmp_path):
    """T5-base (the entry point's model) on a 2x2 mesh of CPU ranks against
    the mesh-free run: the same losses within 1e-5 relative."""
    losses = {}
    for name, mesh in (("one", []), ("mesh", ["--data-parallel", "2",
                                              "--model-parallel", "2"])):
        path = _config(data, tmp_path / name)
        done = _cli(["--config", path, *mesh])
        assert done.returncode == 0, done.stderr[-3000:]
        losses[name] = _losses(tmp_path / name, 0)
        if mesh:
            assert "Mesh: {'data': 2, 'model': 2}" in done.stdout
            assert "on host (mesh run)" in done.stdout
    np.testing.assert_allclose(losses["mesh"], losses["one"], rtol=1e-5)


_KILL_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from t5_resnet_vqa_torch.parallel import launch
import test_torch_mesh_workers as W
config, spec = sys.argv[2], json.loads(sys.argv[3])
launch.spawn(W.trainer_run, 4, (config, spec, (2, 2)))
print("TRAIN_COMPLETED", flush=True)
"""


def _launch_mesh_run(data, out_dir, epochs, resume):
    path = _config(data, out_dir, epochs=epochs, resume=resume)
    raw = json.load(open(path))
    raw["trainer_kwargs"]["checkpoint_every_steps"] = 1
    with open(path, "w") as f:
        json.dump(raw, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    # a session of its own: the kill reaches the launcher and every rank
    return subprocess.Popen(
        [sys.executable, "-u", "-c", _KILL_CHILD,
         os.path.join(REPO, "tests"), path, json.dumps(data["spec"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)


def _run_until(proc, marker, timeout=600):
    lines = []
    t0 = time.time()
    for line in proc.stdout:
        lines.append(line)
        if marker in line:
            return "".join(lines)
        if time.time() - t0 > timeout:
            os.killpg(proc.pid, signal.SIGKILL)
            raise RuntimeError(f"timeout waiting for {marker!r}:\n"
                               + "".join(lines[-30:]))
    return None if proc.wait() != 0 else "".join(lines)


@pytest.mark.slow
def test_sigkill_mid_mesh_training_resumes(data, tmp_path):
    """SIGKILL every process of a live 2x2 run inside its periodic saves; a
    fresh 2x2 run restores the last whole pair, shards it and runs to its
    end, and leaves no half-written file."""
    out = tmp_path / "mesh_kill"
    proc = _launch_mesh_run(data, out, epochs=50, resume=False)
    assert _run_until(proc, "Epoch #1:") is not None
    time.sleep(1.0)                  # inside the background save window
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()

    proc = _launch_mesh_run(data, out, epochs=4, resume=True)
    transcript = _run_until(proc, "TRAIN_COMPLETED")
    assert transcript is not None and proc.wait() == 0, transcript
    assert "Loaded params from checkpoint-model" in transcript
    assert "Loaded Optimizer from Checkpoint" in transcript
    assert "Mesh: {'data': 2, 'model': 2}" in transcript
    ckpt_dir = out / "model_checkpoints"
    debris = [p for p in os.listdir(ckpt_dir)
              if p.endswith((".next", ".tmp"))]
    assert debris == []
    progress = json.load(open(ckpt_dir / "training_progress.json"))
    assert progress["epochs_completed"] == 4
