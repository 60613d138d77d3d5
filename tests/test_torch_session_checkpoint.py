"""``VQAInferenceSession.from_checkpoint`` of the port against the JAX
package's, with a real-vocabulary tokenizer file.

A ``tokenizer.json`` is built offline with the ``tokenizers`` package
(a word-level vocabulary over the synthetic questions and answers) and
named by ``dataset_kwargs.tokenizer_file``. For each family, the JAX
trainer trains the tiny model of ``test_torch_resume.py`` for one epoch
and writes ``best-model`` and ``model_ckpt_info.json``; its params go
through the port's weight bridge into ``best-model.pt`` of a port output
directory, beside the same ``model_ckpt_info.json``. Both packages'
``from_checkpoint`` (with their factories building the tiny model, since
the config's full-width T5-base is too large for a CPU test) then answer the
same requests from the synthetic image files, at ``uint8_wire_images`` true
and false, bilinear and bicubic (the ViT family's collate is bilinear in
both packages whatever the config says): every answer's log-probability
within 1e-4 (fp32). A session whose tokenizer differs
from the checkpoint's raises, and so does one without the checkpoint.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.core.config import Config as JaxConfig
from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.eval import VQAInferenceSession as JaxSession
from t5_resnet_vqa_tpu.train import VQATrainer as JaxTrainer
from t5_resnet_vqa_tpu.train import factory as jax_factory
from t5_resnet_vqa_torch.core import Config
from t5_resnet_vqa_torch.data import load_answer_spaces
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.train import factory
from t5_resnet_vqa_torch.utils import (
    state_dict_from_jax,
    vit_state_dict_from_jax,
)

import test_torch_trainer as cnn_case
import test_torch_vit_trainer as vit_case
from test_torch_resume import _jax_model_and_params

torch.set_num_threads(4)

CASES = {"cnn": cnn_case, "vit": vit_case}
LOGPROB_TOL = 1e-4
INTERPOLATIONS = ("bilinear_interpolation", "bicubic_interpolation")


def _build_tokenizer_file(path, texts):
    """A word-level ``tokenizer.json`` (pad 0, eos 1, unk 2, each sequence
    closed by eos, as T5's), built offline."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    words = sorted({w for t in texts for w in
                    pre_tokenizers.WhitespaceSplit().pre_tokenize_str(t)
                    for w in [w[0]]})
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(words)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    tok.save(path)


@pytest.fixture(scope="module")
def trained(request, tmp_path_factory):
    family = request.param
    case = CASES[family]
    tmp = tmp_path_factory.mktemp(f"serve_{family}")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=4,
                                     num_test=6, image_size=64,
                                     source_hw=(48, 80))
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    texts = []
    for split in (kw["train_csv_file"], kw["test_csv_file"]):
        with open(os.path.join(root, split)) as f:
            texts.append(f.read())
    texts += answers + ["[Question] [Answer]"]
    tokenizer_file = str(tmp / "tokenizer.json")
    _build_tokenizer_file(tokenizer_file, texts)

    jmodel, params = _jax_model_and_params(family, len(answers))
    raw = case._raw_config(root, kw, tmp / "jax", epochs=1)
    raw["dataset_kwargs"]["tokenizer_file"] = tokenizer_file
    raw["trainer_kwargs"]["cache_frozen_features"] = False
    jcfg = JaxConfig.from_json(_write(tmp, raw, "jax.json"))
    JaxTrainer(jmodel, jcfg, answers,
               params=jax.tree_util.tree_map(np.array, params)).train()

    # the JAX best-model through the weight bridge into a port output dir
    src = os.path.join(str(tmp / "jax"), "model_checkpoints")
    from t5_resnet_vqa_tpu.train.callbacks import CheckpointManager
    best = jax.tree_util.tree_map(
        np.asarray, CheckpointManager(str(tmp / "jax")).restore_tree(
            "best-model"))
    state = (state_dict_from_jax(best, "resnet18", 1, 1) if family == "cnn"
             else vit_state_dict_from_jax(best, 1, 1))
    dst = os.path.join(str(tmp / "port"), "model_checkpoints")
    os.makedirs(dst)
    torch.save(state, os.path.join(dst, "best-model.pt"))
    shutil.copy(os.path.join(src, "model_ckpt_info.json"), dst)
    return dict(family=family, case=case, tmp=tmp, root=root, kw=kw,
                raw=raw, jmodel=jmodel, answers=answers,
                images=sorted(os.path.join(root, kw["images_dir"], f)
                              for f in os.listdir(
                                  os.path.join(root, kw["images_dir"]))))


def _write(tmp, raw, name):
    path = os.path.join(str(tmp), name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _config(trained, cls, out_dir, **dataset_kw):
    raw = json.loads(json.dumps(trained["raw"]))
    raw["trainer_kwargs"]["output_dir"] = str(out_dir)
    raw["dataset_kwargs"].update(dataset_kw)
    return cls.from_json(_write(trained["tmp"], raw,
                                f"{cls.__module__.split('.')[0]}.json"))


def _small_factories(trained, monkeypatch):
    """Both factories build the tiny model of the trained family."""
    case = trained["case"]
    monkeypatch.setattr(jax_factory, "build_model",
                        lambda cfg, n: (trained["jmodel"], trained["family"]))
    monkeypatch.setattr(factory, "build_model",
                        lambda cfg, n, device=None, generator=None:
                        (case._port_model(n), trained["family"]))


def _logprobs(results, answers):
    """[N, A] log-probabilities from ``ask_batch(top_k=A)`` results."""
    index = {a: i for i, a in enumerate(answers)}
    out = np.full((len(results), len(answers)), -np.inf)
    for row, r in zip(out, results):
        for a, p in zip(r["top_answers"], r["top_probs"]):
            row[index[a]] = np.log(p)
    return out


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("trained", ["cnn", "vit"], indirect=True)
def test_from_checkpoint_matches_jax(trained, uint8, interpolation,
                                     monkeypatch):
    family = trained["family"]
    _small_factories(trained, monkeypatch)
    kw = dict(uint8_wire_images=uint8, interpolation_strategy=interpolation)
    jax_session = JaxSession.from_checkpoint(
        _config(trained, JaxConfig, trained["tmp"] / "jax", **kw),
        batch_size=4)
    port_session = VQAInferenceSession.from_checkpoint(
        _config(trained, Config, trained["tmp"] / "port", **kw),
        batch_size=4, device="cpu")
    assert port_session.collate.tokenizer.scheme == "tokenizer-file"
    assert port_session.collate.emit_uint8 == uint8
    assert port_session.collate.use_native    # the float path's resize
    if family == "cnn":
        assert port_session.collate.interpolation_strategy == interpolation
    answers = trained["answers"]
    # 6 requests through a batch of 4: the second chunk is padded
    reqs = [(trained["images"][i % len(trained["images"])],
             f"what is on the table {i}") for i in range(6)]
    want = jax_session.ask_batch(reqs, top_k=len(answers))
    got = port_session.ask_batch(reqs, top_k=len(answers))
    assert [g["answer"] for g in got] == [w["answer"] for w in want]
    np.testing.assert_allclose(_logprobs(got, answers),
                               _logprobs(want, answers), rtol=0,
                               atol=LOGPROB_TOL)


@pytest.mark.parametrize("trained", ["cnn", "vit"], indirect=True)
def test_from_checkpoint_guards(trained, monkeypatch, tmp_path):
    _small_factories(trained, monkeypatch)
    # the hash tokenizer against a checkpoint trained on the tokenizer file
    cfg = _config(trained, Config, trained["tmp"] / "port",
                  tokenizer_file="")
    with pytest.raises(ValueError, match="Tokenizer scheme mismatch"):
        VQAInferenceSession.from_checkpoint(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="model_ckpt_info.json"):
        VQAInferenceSession.from_checkpoint(
            _config(trained, Config, tmp_path / "empty"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        VQAInferenceSession.from_checkpoint(
            _config(trained, Config, trained["tmp"] / "port",
                    reduced_decode=2), device="cpu")
