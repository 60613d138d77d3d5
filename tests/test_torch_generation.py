"""Port's greedy and beam generation vs the JAX package's
``models/generation.py``.

The tiny ViT-family model of ``test_torch_vit_vqa.py`` (fp32, weights
through ``vit_state_dict_from_jax``), three rows whose prompts have 12, 7
and 15 tokens. Greedy tokens must be equal; beam tokens equal and scores
within 1e-5. The logits come from random weights, so no two candidates tie
(``jax.lax.top_k`` and ``torch.topk`` may order equal values differently).

EOS and the freezing of finished rows and beams are held on a bigram model
whose next-token logits are a fixed random table indexed by the last
token, with EOS planted on the path of two rows, run through both packages'
generation code.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models import generation as jgen
from t5_resnet_vqa_torch.core import constants
from t5_resnet_vqa_torch.models import generation as pgen
from test_torch_vit_vqa import jax_vit_vqa, make_batch, port_vit_vqa

torch.set_num_threads(2)

EOS = constants.EOS_TOKEN_ID
KEYS = ("question_input_ids", "question_attention_masks",
        "decoder_question_input_ids", "decoder_question_attention_masks",
        "pixel_values")


@pytest.fixture(scope="module")
def models():
    jmodel, params = jax_vit_vqa(seed=3)
    return jmodel, {"params": params}, port_vit_vqa(params)


def _args(seed):
    batch = make_batch(np.random.default_rng(seed))
    return ([batch[k] for k in KEYS],
            [torch.from_numpy(batch[k]) for k in KEYS])


@pytest.mark.parametrize("max_answer_length", [1, 5])
@pytest.mark.parametrize("seed", [20, 21])
def test_greedy_matches_jax(models, max_answer_length, seed):
    jmodel, jparams, model = models
    jargs, targs = _args(seed)
    want = np.asarray(jgen.greedy_generate(
        jmodel, jparams, *jargs, max_answer_length=max_answer_length))
    with torch.inference_mode():
        got = pgen.greedy_generate(model, *targs,
                                   max_answer_length=max_answer_length)
    assert got.shape == (3, max_answer_length)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_beams", [2, 3])
def test_beam_matches_jax(models, num_beams):
    jmodel, jparams, model = models
    jargs, targs = _args(22)
    want_tok, want_score = jgen.beam_generate(
        jmodel, jparams, *jargs, max_answer_length=5, num_beams=num_beams)
    with torch.inference_mode():
        got_tok, got_score = pgen.beam_generate(
            model, *targs, max_answer_length=5, num_beams=num_beams)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_score.dtype == torch.float32
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score),
                               rtol=1e-5, atol=1e-5)


def test_one_beam_is_greedy(models):
    _, _, model = models
    _, targs = _args(23)
    with torch.inference_mode():
        greedy = pgen.greedy_generate(model, *targs, max_answer_length=4)
        beam, scores = pgen.beam_generate(model, *targs, max_answer_length=4,
                                          num_beams=1)
    np.testing.assert_array_equal(beam.numpy(), greedy.numpy())
    assert scores.shape == (3,) and bool(torch.isfinite(scores).all())


# ------------------------------------------------------------ the bigram

V = 16
PROMPTS = [[5, 6, 7], [8, 9], [10, 11, 12, 13]]


def _table():
    t = np.random.default_rng(30).standard_normal((V, V)).astype(np.float32)
    t[7, EOS] = 9.0               # row 0: EOS right away
    t[9, 4] = 9.0                 # row 1: token 4, then EOS
    t[4, EOS] = 9.0
    t[:, 0] = -5.0                # pad is never the best continuation
    return t


class _JaxBigram(fnn.Module):
    def setup(self):
        self.t = self.param("table", lambda _: jnp.asarray(_table()))

    def fuse(self, question_input_ids, question_attention_masks,
             pixel_values):
        return jnp.zeros((question_input_ids.shape[0], 1))

    def decode_vocab_logits(self, ids, mask, fused):
        return self.t[ids]


class _PortBigram:
    def __init__(self):
        self.table = torch.from_numpy(_table())

    def fuse(self, question_input_ids, question_attention_masks,
             pixel_values):
        return torch.zeros(question_input_ids.shape[0], 1)

    def decode_hidden(self, ids, mask, fused):
        return ids[..., None]

    def vocab_logits(self, hidden):
        return self.table[hidden[..., 0].long()]


def _bigram_inputs():
    ids = np.zeros((3, 6), np.int32)
    mask = np.zeros((3, 6), np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = 1
    q = np.ones((3, 2), np.int32)
    pix = np.zeros((3, 1), np.float32)
    return [q, q, ids, mask, pix]


def test_eos_freezes_rows_and_beams_as_jax():
    jmodel = _JaxBigram()
    args = _bigram_inputs()
    params = jmodel.init(jax.random.PRNGKey(0), args[2], args[3],
                         jnp.zeros((3, 1)), method="decode_vocab_logits")
    targs = [torch.from_numpy(a) for a in args]
    port = _PortBigram()

    want = np.asarray(jgen.greedy_generate(jmodel, params, *args,
                                           max_answer_length=4))
    got = pgen.greedy_generate(port, *targs, max_answer_length=4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [EOS, 0, 0, 0]
    assert got[1].tolist() == [4, EOS, 0, 0]

    want_tok, want_score = jgen.beam_generate(
        jmodel, params, *args, max_answer_length=4, num_beams=3)
    got_tok, got_score = pgen.beam_generate(port, *targs, max_answer_length=4,
                                            num_beams=3)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score),
                               rtol=1e-5, atol=1e-5)
    for row in got_tok.numpy():
        after = row[list(row).index(EOS) + 1:] if EOS in row else []
        assert all(t == 0 for t in after)
    assert EOS in got_tok.numpy()[0]
