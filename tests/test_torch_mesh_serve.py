"""Serving on a (data, model) mesh against one device (the cases of the JAX
package's ``tests/test_session_mesh.py``), on spawned gloo ranks.

* ``ask_batch`` of the CNN family (small T5 + SGA, ResNet-18) and the ViT
  family (small ViT + T5 encoder-decoder), with production dropout rates,
  at dp=2, tp=2 and 2x2 against the one-device session on the same
  weights: 6 requests through a batch
  of 4 (the second chunk padded), the same top-3 answers on every rank,
  probabilities within 1e-5 (fp32; tp sums in another order).
* Greedy ``generate_batch`` of the ViT family: the same tokens on every
  mesh.
* A batch that does not divide over the data axis raises ``ValueError``
  naming the data axis.
* ``python -m t5_resnet_vqa_torch.serve`` on a 2x2 mesh (the entry point's
  ``serve_rank``): rank 0 binds the port and answers /healthz, /v1/ask,
  /v1/ask_batch and a refused /v1/generate; the other ranks follow each
  call and leave when rank 0 closes; the answers equal the one-device
  session's.
"""

import json
import os

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.data import load_answer_spaces, make_synthetic_daquar
from t5_resnet_vqa_torch.parallel import launch

import test_torch_mesh_workers as W

SHAPES = [None, (2, 1), (1, 2), (2, 2)]
# production dropout rates: a served model is in eval() and drops nothing,
# also after the mesh has put its own dropouts in
T5_KW = dict(vocab_size=32128, d_model=32, d_kv=8, d_ff=64, num_layers=1,
             num_decoder_layers=1, num_heads=4, dropout_rate=0.1)
MODELS = {
    "cnn": dict(vision_model_name="resnet18", num_attention_blocks=1,
                t5=T5_KW, sga=dict(hidden_size=32, num_heads=4, ff_size=32,
                                   dropout_rate=0.1)),
    "vit": dict(t5=T5_KW, fusing_dropout=0.5,
                vit=dict(hidden_size=32, num_layers=2, num_heads=4,
                         mlp_dim=64, patch_size=32, image_size=224)),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=4,
                                     num_test=4, image_size=64,
                                     source_hw=(48, 80))
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    images_dir = os.path.join(root, kw["images_dir"])
    images = [os.path.join(images_dir, f)
              for f in sorted(os.listdir(images_dir))]
    return dict(tmp=tmp, root=root, kw=kw, answers=answers, images=images)


def _spec(family, data):
    kw = dict(MODELS[family], answers=len(data["answers"]), seed=3)
    requests = [(data["images"][i % len(data["images"])],
                 f"what is on the table number {i}") for i in range(6)]
    return dict(family=family, model=kw,
                state=W.build_model(family, kw).state_dict(),
                answers=data["answers"], batch_size=4, image_size=64,
                requests=requests)


@pytest.mark.parametrize("family", ["cnn", "vit"])
def test_mesh_serving_matches_one_device(family, data, tmp_path):
    ranks = launch.spawn(W.serve, 4, (_spec(family, data), SHAPES),
                         store_dir=str(tmp_path))
    one = ranks[0][0]
    assert len(one["ask"]) == 6
    for r, per_shape in enumerate(ranks):
        for shape, got in zip(SHAPES, per_shape):
            if got is None:
                continue
            for a, b in zip(got["ask"], one["ask"]):
                assert a["top_answers"] == b["top_answers"], (r, shape)
                np.testing.assert_allclose(a["top_probs"], b["top_probs"],
                                           rtol=1e-5, atol=1e-7)
            if family == "vit":
                assert [g["token_ids"] for g in got["generate"]] == \
                    [g["token_ids"] for g in one["generate"]], (r, shape)
    assert sum(x is not None for x in ranks[3]) == 2   # one device, 2x2


def test_indivisible_batch_raises(data, tmp_path):
    errors = launch.spawn(W.session_refuses_indivisible_batch, 2,
                          (_spec("cnn", data),), store_dir=str(tmp_path))
    assert all("data axis" in e for e in errors)


def test_serve_entry_point_on_a_mesh(data, tmp_path):
    answers = data["answers"]
    spec = _spec("cnn", data)
    out_dir = tmp_path / "run"
    ckpt = out_dir / "model_checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(spec["state"], str(ckpt / "best-model.pt"))
    with open(ckpt / "model_ckpt_info.json", "w") as f:
        json.dump({"answer_spaces": answers}, f)
    config = {"model_kwargs": {"vision_model_name": "resnet18"},
              "dataset_kwargs": dict(data["kw"], root_data_dir=data["root"],
                                     image_size=64,
                                     use_native_preprocessor=False),
              "trainer_kwargs": {"device": "cpu",
                                 "output_dir": str(out_dir)}}
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    argv = ["--config", path, "--port", "0", "--batch-size", "2",
            "--data-parallel", "2", "--model-parallel", "2"]
    ranks = launch.spawn(W.http_rank, 4, (argv, spec, data["images"][0]),
                         store_dir=str(tmp_path / "store"))
    calls = ranks[0]
    assert calls["health"][0] == 200
    assert calls["health"][1]["batch_size"] == 2
    status, res = calls["ask"]
    assert status == 200 and res["answer"] in answers
    status, res = calls["batch"]
    assert status == 200 and len(res["results"]) == 3
    assert calls["generate"][0] == 400
    # each follower ran the three model calls, the refused one included
    assert ranks[1:] == [3, 3, 3]

    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    one = VQAInferenceSession(
        W.build_model("cnn", spec["model"]), spec["state"], answers,
        batch_size=2, image_size=64, device="cpu")
    want = one.ask(data["images"][0], "what is here", top_k=2)
    assert calls["ask"][1]["top_answers"] == want["top_answers"]
    np.testing.assert_allclose(calls["ask"][1]["top_probs"],
                               want["top_probs"], rtol=1e-5, atol=1e-7)
