"""The port's checkpoint loop and resume against the JAX package's trainer.

For each family (the tiny CNN and ViT trainers of ``test_torch_trainer.py``
and ``test_torch_vit_trainer.py``: dropout 0, the cv2 image path, the same
initial params on both sides), both packages train 2 epochs of 3 steps with
``checkpoint_every_steps=2`` and ``compute_rouge``; the port's run also
traces epoch 0 into ``trace_dir``. Then each resumes
(``load_from_checkpoint``) from its own output:

* from the pair: the same resume point (epoch 2, step 6), the same LRs
  (1e-7 relative) and the same log lines; the port's restored model,
  optimizer (AdamW moments, AMSGrad's ``max_exp_avg_sq``, step counts) and
  scheduler state equal, bit for bit, both the files and the state the
  first run ended with; one more epoch then gives the JAX package's loss
  within 3e-4 (the train-step tolerance), so the restored optimizer state
  is the one JAX restores;
* from ``best-model`` alone (the pair removed): weights only, step 0, and
  the same "skipping" and staleness lines.

The periodic saves, the ROUGE lines and records and the trace are checked
on the first runs. Last, a training process is killed with SIGKILL twice
(once just after an epoch's pair was submitted, once mid-epoch after a
resume) and resumed to the end, as ``tests/test_kill_resume.py`` does for
the JAX package, with its own time limit.
"""

import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxCnnModel
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.models.vit_vqa import VitVQAModel as JaxVitModel
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_tpu.train import VQATrainer as JaxTrainer
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import load_answer_spaces
from t5_resnet_vqa_torch.train import VQATrainer

import test_torch_trainer as cnn_case
import test_torch_vit_trainer as vit_case
from test_torch_train_step import _random_params

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"cnn": cnn_case, "vit": vit_case}
STEPS_PER_EPOCH = 3
RESUME_LINES = ("Loaded params from checkpoint-model",
                "Loaded Optimizer from Checkpoint",
                "Resume point is fresh",
                "Loaded from Best Model",
                "Skipping optimizer state restore",
                "WARNING: resuming at epoch")


def _jax_model_and_params(family, num_answers):
    rng = np.random.default_rng(0)
    if family == "cnn":
        model = JaxCnnModel(answer_spaces=num_answers,
                            vision_model_name="resnet18",
                            t5_config=JaxT5Config(**cnn_case.T5_KW),
                            sga_config=JaxAttentionConfig(**cnn_case.SGA_KW),
                            num_attention_blocks=1)
        batch = dict(question_input_ids=np.ones((2, 16), np.int32),
                     question_attention_masks=np.ones((2, 16), np.int32),
                     image_tensors=np.zeros((2, 64, 64, 3), np.uint8))
        return model, _random_params(model, batch, rng)
    model = JaxVitModel(answer_spaces=num_answers,
                        t5_config=JaxT5Config(**vit_case.T5_KW),
                        vit_config=JaxViTConfig(**vit_case.VIT_KW),
                        fusing_dropout=0.0)
    batch = dict(question_input_ids=np.ones((2, 16), np.int32),
                 question_attention_masks=np.ones((2, 16), np.int32),
                 decoder_question_input_ids=np.ones((2, 20), np.int32),
                 decoder_question_attention_masks=np.ones((2, 20), np.int32),
                 pixel_values=np.zeros((2, 224, 224, 3), np.uint8))
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), **batch)["params"])
    vm = dict(params["vision_model"])
    for k in ("cls_token", "position_embeddings"):
        vm[k] = rng.normal(0.0, 0.5, vm[k].shape).astype(np.float32)
    return model, {**params, "vision_model": vm}


def _trainer(run, name, out_dir, cfg_name, **trainer_kw):
    """A trainer of ``run``'s family from its initial params."""
    case, tmp = CASES[run["family"]], run["tmp"]
    raw = case._raw_config(run["root"], run["kw"], out_dir, **trainer_kw)
    path = os.path.join(str(tmp), f"{name}_{cfg_name}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    if name == "jax":
        return JaxTrainer(run["jmodel"], JaxConfig.from_json(path),
                          run["answers"],
                          params=jax.tree_util.tree_map(np.array,
                                                        run["params"]))
    return VQATrainer(case._port_model(len(run["answers"]), run["params"]),
                      Config.from_json(path), run["answers"])


def _log(trainer):
    with open(trainer.logger.log_path) as f:
        return f.read()


def _lines(log, markers=RESUME_LINES):
    """{marker: the text of the line from the marker on} for the markers
    the log has."""
    out = {}
    for line in log.splitlines():
        for m in markers:
            if m in line:
                out[m] = line[line.index(m):]
    return out


def _records(out_dir, key):
    with open(os.path.join(str(out_dir), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r[key] for r in rows if r.get("_event") == "log" and key in r]


@pytest.fixture(scope="module", params=["cnn", "vit"])
def run(request, tmp_path_factory):
    family = request.param
    tmp = tmp_path_factory.mktemp(f"resume_{family}")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"),
                                     num_train=4 * STEPS_PER_EPOCH,
                                     num_test=6, image_size=64)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    jmodel, params = _jax_model_and_params(family, len(answers))
    run = dict(family=family, tmp=tmp, root=root, kw=kw, answers=answers,
               jmodel=jmodel, params=params, first={})
    for name in ("jax", "port"):
        extra = {"trace_dir": str(tmp / "trace")} if name == "port" else {}
        trainer = _trainer(run, name, tmp / name, "first",
                           checkpoint_every_steps=2, compute_rouge=True,
                           **extra)
        trainer.train()
        run["first"][name] = trainer
    return run


def _ckpt(out_dir, name):
    return torch.load(os.path.join(str(out_dir), "model_checkpoints", name),
                      map_location="cpu", weights_only=True)


def _assert_same_tree(got, want, where):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want.cpu()), \
            where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def test_pair_resume_matches_jax(run):
    tmp = run["tmp"]
    resumed = {}
    for name in ("jax", "port"):
        shutil.copytree(os.path.join(str(tmp / name), "model_checkpoints"),
                        os.path.join(str(tmp / f"{name}_resume"),
                                     "model_checkpoints"))
        resumed[name] = _trainer(run, name, tmp / f"{name}_resume", "resume",
                                 epochs=3, load_from_checkpoint=True)
    port, jx = resumed["port"], resumed["jax"]
    assert (port.start_epoch, port.global_step) == \
        (jx.start_epoch, jx.global_step) == (2, 2 * STEPS_PER_EPOCH)
    lrs = port._current_lrs()
    assert lrs == pytest.approx(jx._current_lrs(), rel=1e-7, abs=0)
    for group in port.optimizer.param_groups:
        assert group["lr"] == pytest.approx(lrs[group["group"]], rel=1e-12)
    got, want = _lines(_log(port)), _lines(_log(jx))
    assert set(got) == {"Loaded params from checkpoint-model",
                        "Loaded Optimizer from Checkpoint",
                        "Resume point is fresh"}
    assert got == want
    assert got["Loaded Optimizer from Checkpoint"].endswith(
        "(epoch 2, step 6)")

    # the restored state, bit for bit: the files, and the first run's end
    first = run["first"]["port"]
    params = _ckpt(tmp / "port", "checkpoint-model.pt")
    state = _ckpt(tmp / "port", "state_dict_checkpoint.pt")
    assert (state["epoch"], state["global_step"]) == (2, 6)
    _assert_same_tree(port.model.state_dict(), params, "model")
    _assert_same_tree(port.model.state_dict(), first.model.state_dict(),
                      "model")
    restored = port.optimizer.state_dict()
    for want in (state["optimizer"], first.optimizer.state_dict()):
        _assert_same_tree(restored["state"], want["state"], "moments")
        # this run's LRs come from its own, longer schedule
        strip = lambda groups: [{k: v for k, v in g.items() if k != "lr"}
                                for g in groups]
        assert strip(restored["param_groups"]) == \
            strip(want["param_groups"])
    moments = next(iter(restored["state"].values()))
    assert set(moments) >= {"step", "exp_avg", "exp_avg_sq",
                            "max_exp_avg_sq"}
    assert port.scheduler.last_epoch == first.scheduler.last_epoch == 6

    # one more epoch from the restored state, in both packages
    for trainer in (port, jx):
        trainer.train()
    got, want = (_records(tmp / f"{n}_resume", "train_avg_loss")
                 for n in ("port", "jax"))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_best_model_resume_matches_jax(run):
    tmp = run["tmp"]
    resumed = {}
    for name, pair_member in (("jax", "checkpoint-model"),
                              ("port", "checkpoint-model.pt")):
        src = os.path.join(str(tmp / name), "model_checkpoints")
        dst = tmp / f"{name}_best_only"
        shutil.copytree(src, os.path.join(str(dst), "model_checkpoints"))
        victim = os.path.join(str(dst), "model_checkpoints", pair_member)
        (shutil.rmtree if os.path.isdir(victim) else os.remove)(victim)
        resumed[name] = _trainer(run, name, dst, "best_only",
                                 load_from_checkpoint=True)
    port, jx = resumed["port"], resumed["jax"]
    assert (port.start_epoch, port.global_step) == \
        (jx.start_epoch, jx.global_step) == (0, 0)
    assert port._current_lrs() == pytest.approx(jx._current_lrs(), rel=1e-7)
    got, want = _lines(_log(port)), _lines(_log(jx))
    assert set(got) == {"Loaded from Best Model",
                        "Skipping optimizer state restore",
                        "WARNING: resuming at epoch"}
    assert got == want
    assert "2 epoch(s) of work will be re-run" in \
        got["WARNING: resuming at epoch"]
    best = _ckpt(tmp / "port", "best-model.pt")
    _assert_same_tree(port.model.state_dict(), best, "model")
    assert port.optimizer.state_dict()["state"] == {}


def test_periodic_pairs_and_rouge_match_jax(run):
    logs = {n: _log(t) for n, t in run["first"].items()}
    # steps 2 and 5 (periodic) and 3 and 6 (epoch ends)
    for log in logs.values():
        assert log.count("Saving Epoch Checkpoint") == 4
    rouge = {n: [ln[ln.index("Validation ROUGE:"):]
                 for ln in log.splitlines() if "Validation ROUGE:" in ln]
             for n, log in logs.items()}
    assert len(rouge["port"]) == 2 and rouge["port"] == rouge["jax"]
    assert "ROUGE stemming: on (nltk PorterStemmer)" in logs["port"]
    for key in ("valid_rouge1_f", "valid_rouge2_f", "valid_rougeL_f"):
        got, want = (_records(run["tmp"] / n, key) for n in ("port", "jax"))
        assert len(got) == 2 and got == pytest.approx(want, abs=1e-12), key
    progress = run["first"]["port"].callbacks.ckpt.read_json(
        "training_progress.json")
    assert progress == {"epochs_completed": 2, "global_step": 6}


def test_trace_dir_writes_a_trace(run):
    files = os.listdir(run["tmp"] / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(run["tmp"] / "trace" / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "Optimizer.step#AdamW.step" in names


@pytest.mark.parametrize("bound", [1, 0, -1])
def test_checkpoint_lag_bound(bound, tmp_path, monkeypatch):
    """``max_checkpoint_lag_epochs``: the writer is held shut until the
    trainer itself drains the queue, so only the bound can move the durable
    epoch; as in the JAX package's ``test_checkpoint_lag_bound_enforced``
    and ``..._disabled_and_sync``."""
    from t5_resnet_vqa_torch.train.callbacks import CheckpointManager

    root, kw = make_synthetic_daquar(str(tmp_path / "daquar"), num_train=4,
                                     num_test=4, image_size=32)
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    raw = cnn_case._raw_config(root, kw, tmp_path / "out", epochs=3,
                               monitor_test=False,
                               max_checkpoint_lag_epochs=bound)
    trainer = VQATrainer(cnn_case._port_model(len(answers)),
                         Config.from_json(cnn_case._write(tmp_path, raw)),
                         answers)
    gate = threading.Event()
    save, flush = CheckpointManager._save_pair_sync, CheckpointManager.flush

    def gated_save(self, *a, **kw):
        assert gate.wait(60), "the queue was never drained"
        return save(self, *a, **kw)

    def opening_flush(self):
        gate.set()                      # only a drain lets a save land
        return flush(self)

    monkeypatch.setattr(CheckpointManager, "_save_pair_sync", gated_save)
    monkeypatch.setattr(CheckpointManager, "flush", opening_flush)
    seen = []
    enforce = trainer._enforce_checkpoint_lag_bound
    monkeypatch.setattr(trainer, "_enforce_checkpoint_lag_bound",
                        lambda e: (enforce(e),
                                   seen.append((e, trainer._durable_epoch))))
    trainer.train()
    if bound < 0:
        # never waits: nothing lands before train()'s own flush
        assert seen == [(1, 0), (2, 0), (3, 0)]
    else:
        assert all(e - d <= bound for e, d in seen), seen
    if bound == 0:
        assert seen == [(1, 1), (2, 2), (3, 3)]
    log = _log(trainer)
    assert ("Checkpoint lag reached 2 epoch(s) > max_checkpoint_lag_epochs=1"
            in log) == (bound == 1)
    state = trainer.callbacks.ckpt.restore_tree("state_dict_checkpoint")
    assert (state["epoch"], state["global_step"]) == (3, 3)


_CHILD = r"""
import sys
sys.modules["nltk"] = None      # WUPS falls back to its mini-WordNet at once
import torch
torch.set_num_threads(1)
root, out_dir, epochs, resume = sys.argv[1:5]

from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import HashTokenizer, load_answer_spaces
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train import VQATrainer

cfg = Config()
cfg.dataset.root_data_dir = root
cfg.dataset.train_batch_size = 4
cfg.dataset.test_batch_size = 4
cfg.dataset.image_size = 32
cfg.trainer.epochs = int(epochs)
cfg.trainer.output_dir = out_dir
cfg.trainer.device = "cpu"
cfg.trainer.checkpoint_every_steps = 1       # save constantly
cfg.trainer.cache_frozen_features = False
cfg.trainer.load_from_checkpoint = resume == "1"
cfg.callbacks.threshold = -1.0
cfg = cfg.validate()

answers = load_answer_spaces(root + "/answer_spaces.txt")
model = ResnetVQAModel(
    len(answers), vision_model_name="resnet18",
    t5_config=T5Config(vocab_size=32128, d_model=32, d_kv=8, d_ff=64,
                       num_layers=1, num_decoder_layers=1, num_heads=4),
    sga_config=AttentionConfig(hidden_size=32, num_heads=4, ff_size=32),
    num_attention_blocks=1, device="cpu")
# the tokenizer the trainer would fall back to, without importing
# transformers first (seconds per process)
tokenizer = HashTokenizer(pinned_words=answers)
VQATrainer(model, cfg, answers, tokenizer=tokenizer).train()
print("TRAIN_COMPLETED", flush=True)
"""

KILL_TEST_S = 120       # the whole kill-and-resume test, three processes


class _Child:
    """A training process whose output lines are read by a thread, so that
    every wait has a deadline."""

    def __init__(self, root, out_dir, epochs, resume):
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-c", _CHILD, root, out_dir, str(epochs),
             "1" if resume else "0"], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        self.seen = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, marker, deadline):
        while True:
            try:
                line = self.lines.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                line = ""
            if line is None or time.time() > deadline:
                self.proc.kill()
                raise AssertionError(f"no {marker!r} in time:\n"
                                     + "".join(self.seen[-30:]))
            self.seen.append(line)
            if marker in line:
                return

    def kill(self):
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)


def test_sigkill_twice_resumes(tmp_path):
    deadline = time.time() + KILL_TEST_S
    root = str(tmp_path / "daquar")
    make_synthetic_daquar(root, num_train=8, num_test=4, image_size=32)
    out = str(tmp_path / "out")

    # kill 1: right after epoch 1's steps, while its saves are in flight
    child = _Child(root, out, epochs=50, resume=False)
    child.wait_for("Epoch #1:", deadline)
    child.kill()

    # kill 2: the resume found the pair, then mid-epoch after a step log
    child = _Child(root, out, epochs=50, resume=True)
    child.wait_for("Loaded params from checkpoint-model", deadline)
    child.wait_for("Loaded Optimizer from Checkpoint", deadline)
    child.wait_for("- iteration 0/", deadline)
    child.kill()

    child = _Child(root, out, epochs=4, resume=True)
    child.wait_for("TRAIN_COMPLETED", deadline)
    assert child.proc.wait(30) == 0
    log = "".join(child.seen)
    assert "Loaded params from checkpoint-model" in log
    assert "Loaded Optimizer from Checkpoint" in log
    ckpt_dir = os.path.join(out, "model_checkpoints")
    assert [p for p in os.listdir(ckpt_dir)
            if p.endswith((".next", ".tmp"))] == []
    state = torch.load(os.path.join(ckpt_dir, "state_dict_checkpoint.pt"),
                       weights_only=True)
    assert state["epoch"] == 4
