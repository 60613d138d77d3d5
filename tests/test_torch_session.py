"""The port's serving path vs the JAX package's: collate and session.

On ``make_synthetic_daquar`` data (same seed), the port's
``DaquarCnnCollate`` must give byte-equal uint8 images, ids, masks and
labels. Then ``VQAInferenceSession.ask_batch(device="cpu")`` on the same
weights and image files must give the JAX session's answers, with top-k
probabilities within 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.data import DaquarDataset, make_synthetic_daquar
from t5_resnet_vqa_tpu.data.collate import DaquarCnnCollate as JaxCollate
from t5_resnet_vqa_tpu.eval import VQAInferenceSession as JaxSession
from t5_resnet_vqa_tpu.models.resnet_vqa import ResnetVQAModel as JaxModel
from t5_resnet_vqa_tpu.models.t5 import T5Config as JaxT5Config
from t5_resnet_vqa_tpu.ops import AttentionConfig as JaxAttentionConfig
from t5_resnet_vqa_torch.data import DaquarCnnCollate
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.utils import state_dict_from_jax

torch.set_num_threads(2)

T5_KW = dict(vocab_size=32128, d_model=32, d_kv=8, d_ff=64, num_layers=1,
             num_decoder_layers=1, num_heads=4)
SGA_KW = dict(hidden_size=32, num_heads=4, ff_size=32)


@pytest.fixture(scope="module")
def daquar(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("daquar_torch"))
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
def test_collate_matches_jax(daquar, emit_uint8):
    answers, samples, _ = daquar
    kw = dict(resizing_dimensions=(64, 64), eval_mode=True,
              emit_uint8=emit_uint8)
    want = JaxCollate(answers, **kw)(samples)
    got = DaquarCnnCollate(answers, **kw)(samples)
    assert sorted(got) == sorted(want)
    for key in ("question_input_ids", "question_attention_masks",
                "decoder_question_input_ids",
                "decoder_question_attention_masks", "annotation_ids",
                "answer_input_ids", "answer_attention_masks"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["answers"] == want["answers"]
    assert got["image_fns"] == want["image_fns"]
    if emit_uint8:
        assert got["image_tensors"].dtype == np.uint8
        np.testing.assert_array_equal(got["image_tensors"],
                                      want["image_tensors"])
    else:
        # the JAX float path may take its native resize, which agrees with
        # the cv2 path within one uint8 step
        np.testing.assert_allclose(got["image_tensors"],
                                   want["image_tensors"], rtol=0,
                                   atol=1.0 / 255 + 1e-6)


def test_collate_without_images(daquar):
    answers, samples, _ = daquar
    collate = DaquarCnnCollate(answers, resizing_dimensions=(64, 64))
    collate.emit_images = False
    assert "image_tensors" not in collate(samples)


@pytest.fixture(scope="module")
def sessions(daquar):
    answers, _, image_paths = daquar
    model = JaxModel(answer_spaces=len(answers), vision_model_name="resnet18",
                     t5_config=JaxT5Config(**T5_KW),
                     sga_config=JaxAttentionConfig(**SGA_KW),
                     num_attention_blocks=1)
    rng = np.random.default_rng(0)
    params = model.init(
        jax.random.PRNGKey(0),
        question_input_ids=np.zeros((2, 16), np.int32),
        question_attention_masks=np.ones((2, 16), np.int32),
        image_tensors=rng.random((2, 64, 64, 3)).astype(np.float32),
    )["params"]
    jax_session = JaxSession(model, params, answers, "cnn", batch_size=4,
                             image_size=64)
    port_model = ResnetVQAModel(len(answers), vision_model_name="resnet18",
                                t5_config=T5Config(**T5_KW),
                                num_attention_blocks=1,
                                sga_config=AttentionConfig(**SGA_KW),
                                device="cpu")
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                "resnet18", 1, T5_KW["num_layers"])
    port_session = VQAInferenceSession(port_model, state, answers, "cnn",
                                       batch_size=4, image_size=64,
                                       device="cpu")
    return jax_session, port_session, answers, image_paths


def test_ask_batch_matches_jax_session(sessions):
    jax_session, port_session, answers, images = sessions
    # 6 requests through a batch of 4: two chunks, the second padded
    reqs = [(images[i % len(images)], f"what is on the table {i}?")
            for i in range(6)]
    want = jax_session.ask_batch(reqs, top_k=3)
    got = port_session.ask_batch(reqs, top_k=3)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"]
        assert g["top_answers"] == w["top_answers"]
        np.testing.assert_allclose(g["top_probs"], w["top_probs"], rtol=0,
                                   atol=1e-4)


def test_ask_single_matches_batch(sessions):
    _, port_session, answers, images = sessions
    single = port_session.ask(images[1], "what colour is the lamp?", top_k=2)
    batch = port_session.ask_batch(
        [(images[0], "a?"), (images[1], "what colour is the lamp?")],
        top_k=2)
    assert single["answer"] in answers
    assert single["top_answers"] == batch[1]["top_answers"]
    np.testing.assert_allclose(single["top_probs"], batch[1]["top_probs"],
                               rtol=1e-6)
    assert single["top_probs"] == sorted(single["top_probs"], reverse=True)


def test_session_model_is_in_eval_mode(sessions):
    _, port_session, _, _ = sessions
    assert not port_session.model.training
    assert port_session.device == torch.device("cpu")


def test_session_refuses_other_families(sessions):
    # every family of the JAX package is served (cross_attention too:
    # tests/test_torch_family_trainer.py); a name that is none raises
    _, port_session, answers, _ = sessions
    with pytest.raises(NotImplementedError, match="cnn"):
        VQAInferenceSession(port_session.model, None, answers,
                            "detr", device="cpu")
