"""The port's ViT-family serving path vs the JAX package's: collate, session,
generation through the session, tokenizer decoding.

On ``make_synthetic_daquar`` data (same seed), the port's
``DaquarVitCollate`` must give byte-equal batches to the JAX one's, in
uint8 and in fp32 (224^2 bilinear, normalized with mean = std = 0.5; the
JAX collate on its cv2 path). Then, on the same weights and image files,
``VQAInferenceSession(family="vit", device="cpu")`` must give the JAX
session's answers (top-k probabilities within 1e-5) and generated token
ids (beam scores within 1e-5). The model: a ViT of hidden 32 over 224^2
images in 32x32 patches (50 tokens), a T5 with d_model 32, one layer per
stack and the full 32128-row table (the tokenizer's ids reach 32113).
"""

import os

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.data import DaquarDataset, make_synthetic_daquar
from t5_resnet_vqa_tpu.data.collate import DaquarVitCollate as JaxCollate
from t5_resnet_vqa_tpu.data.tokenizer import HashTokenizer as JaxTokenizer
from t5_resnet_vqa_tpu.eval import VQAInferenceSession as JaxSession
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.models.vit import ViTConfig as JaxViTConfig
from t5_resnet_vqa_tpu.models.vit_vqa import VitVQAModel as JaxModel
from t5_resnet_vqa_torch.core.config import ModelConfig
from t5_resnet_vqa_torch.data import DaquarVitCollate, HashTokenizer
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import (
    ResnetVQAModel,
    T5Config,
    ViTConfig,
    VitVQAModel,
)
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train import factory
from t5_resnet_vqa_torch.utils import vit_state_dict_from_jax

torch.set_num_threads(2)

T5_KW = dict(vocab_size=32128, d_model=32, d_kv=8, d_ff=64, num_layers=1,
             num_decoder_layers=1, num_heads=4)
VIT_KW = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64,
              patch_size=32, image_size=224)
TEXT_KEYS = ("question_input_ids", "question_attention_masks",
             "decoder_question_input_ids", "decoder_question_attention_masks",
             "annotation_ids", "answer_input_ids", "answer_attention_masks")


@pytest.fixture(scope="module")
def daquar(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("daquar_vit_torch"))
    root, kw = make_synthetic_daquar(root, num_train=4, num_test=6,
                                     image_size=64, source_hw=(48, 80))
    answers = [a.strip("\n") for a in
               open(os.path.join(root, kw["answer_spaces_file"]))]
    dataset = DaquarDataset(root, kw["test_csv_file"], kw["images_dir"])
    samples = [dataset[i] for i in range(len(dataset))]
    images_dir = os.path.join(root, kw["images_dir"])
    image_paths = [os.path.join(images_dir, f)
                   for f in sorted(os.listdir(images_dir))]
    return answers, samples, image_paths


@pytest.mark.parametrize("emit_uint8", [True, False])
def test_vit_collate_matches_jax(daquar, emit_uint8):
    answers, samples, _ = daquar
    want = JaxCollate(answers, eval_mode=True, emit_uint8=emit_uint8,
                      use_native=False)(samples)
    # both on the cv2 path (the native path: test_torch_rouge_native.py)
    got = DaquarVitCollate(answers, eval_mode=True, emit_uint8=emit_uint8,
                           use_native=False)(samples)
    assert sorted(got) == sorted(want)
    assert "image_tensors" not in got
    for key in TEXT_KEYS + ("pixel_values",):
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["pixel_values"].shape == (len(samples), 224, 224, 3)
    assert got["pixel_values"].dtype == (np.uint8 if emit_uint8
                                         else np.float32)
    if not emit_uint8:
        assert got["pixel_values"].min() >= -1.0
        assert got["pixel_values"].max() <= 1.0
    assert got["answers"] == want["answers"]
    assert got["image_fns"] == want["image_fns"]


@pytest.fixture(scope="module")
def sessions(daquar):
    answers, _, image_paths = daquar
    model = JaxModel(answer_spaces=len(answers),
                     t5_config=JaxT5Config(**T5_KW),
                     vit_config=JaxViTConfig(**VIT_KW, use_pallas=True))
    rng = np.random.default_rng(0)
    params = model.init(
        jax.random.PRNGKey(0),
        question_input_ids=np.zeros((2, 16), np.int32),
        question_attention_masks=np.ones((2, 16), np.int32),
        decoder_question_input_ids=np.zeros((2, 20), np.int32),
        decoder_question_attention_masks=np.ones((2, 20), np.int32),
        pixel_values=rng.random((2, 224, 224, 3)).astype(np.float32),
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    vm = dict(params["vision_model"])
    for k in ("cls_token", "position_embeddings"):
        vm[k] = rng.normal(0.0, 0.5, vm[k].shape).astype(np.float32)
    params = {**params, "vision_model": vm}
    jax_session = JaxSession(model, params, answers, "vit", batch_size=4)
    port_model = VitVQAModel(len(answers), t5_config=T5Config(**T5_KW),
                             vit_config=ViTConfig(**VIT_KW), device="cpu")
    state = vit_state_dict_from_jax(params, VIT_KW["num_layers"],
                                    T5_KW["num_layers"])
    port_session = VQAInferenceSession(port_model, state, answers, "vit",
                                       batch_size=4, device="cpu")
    # 6 requests through a batch of 4: two chunks, the second padded
    requests = [(image_paths[i % len(image_paths)],
                 f"what is on the table number {i}?") for i in range(6)]
    return jax_session, port_session, answers, requests


def test_vit_ask_batch_matches_jax_session(sessions):
    jax_session, port_session, _, requests = sessions
    want = jax_session.ask_batch(requests, top_k=3)
    got = port_session.ask_batch(requests, top_k=3)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"]
        assert g["top_answers"] == w["top_answers"]
        np.testing.assert_allclose(g["top_probs"], w["top_probs"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("num_beams", [1, 3])
def test_generate_batch_matches_jax_session(sessions, num_beams):
    jax_session, port_session, _, requests = sessions
    with pytest.warns(UserWarning, match="hash"):
        want = jax_session.generate_batch(requests, num_beams=num_beams,
                                          max_answer_length=4)
    with pytest.warns(UserWarning, match="hash"):
        got = port_session.generate_batch(requests, num_beams=num_beams,
                                          max_answer_length=4)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["token_ids"] == w["token_ids"]
        assert g["answer_text"] == w["answer_text"]
        if num_beams > 1:
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5,
                                       atol=1e-5)
    assert any(g["token_ids"] for g in got)
    with pytest.warns(UserWarning, match="hash"):
        single = port_session.generate(*requests[1], num_beams=num_beams,
                                       max_answer_length=4)
    assert single["token_ids"] == got[1]["token_ids"]


def test_generate_batch_raises_for_the_cnn_family(daquar):
    answers, _, image_paths = daquar
    model = ResnetVQAModel(
        len(answers), vision_model_name="resnet18",
        t5_config=T5Config(vocab_size=32128, d_model=16, d_kv=4, d_ff=32,
                           num_layers=1, num_heads=4),
        num_attention_blocks=1,
        sga_config=AttentionConfig(hidden_size=16, num_heads=4, ff_size=16),
        device="cpu")
    session = VQAInferenceSession(model, None, answers, "cnn", batch_size=2,
                                  image_size=64, device="cpu")
    with pytest.raises(ValueError, match="ViT"):
        session.generate_batch([(image_paths[0], "what is it?")])
    assert session.ask(image_paths[0], "what is it?")["answer"] in answers


@pytest.mark.parametrize("skip_special_tokens", [True, False])
def test_tokenizer_decode_matches_jax(skip_special_tokens):
    answers = ["chair", "table", "lamp"]
    ours, theirs = HashTokenizer(pinned_words=answers), \
        JaxTokenizer(pinned_words=answers)
    ids, _ = ours(["[Question] what is near the chair ? [Answer]"], 20)
    seq = list(ids[0]) + [32101, 1, 0, 0, 123]
    assert ours.decode(seq, skip_special_tokens) == \
        theirs.decode(seq, skip_special_tokens)
    assert ours.decode_specials(seq) == theirs.decode_specials(seq)
    assert "[Answer]" in ours.decode_specials(seq)


def test_factory_builds_the_vit_family(monkeypatch):
    """``build_model`` routes a ViT config to ``VitVQAModel`` with the
    kernel route on (the constructor is stubbed: the full-width model is
    the card's to build)."""
    built = {}

    def stub(num_answers, **kw):
        built.update(kw, num_answers=num_answers)
        return "model"

    monkeypatch.setattr(factory, "VitVQAModel", stub)
    cfg = ModelConfig(vision_model_name="google/vit-base-patch16-224-in21k",
                      language_model_name="t5-base")
    assert factory.model_family(cfg) == factory.VIT_FAMILY
    model, family = factory.build_model(cfg, 7, device="cpu")
    assert (model, family) == ("model", "vit")
    assert built["num_answers"] == 7 and built["use_kernels"] is True
    assert built["t5_config"] == T5Config.t5_base()
    assert built["device"] == "cpu"
