"""Each configuration's plain reference against the port's plain path at a
small width on the CPU, and whole runs of each cell there (float32, the
port's CPU route in place of its kernels)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpu_bench import generate, harness
from gpu_bench.reference import inputs
from gpu_bench.reference.nn import FP32
from gpu_bench.run import run_cell
from gpu_bench.tests import tiny

BENCH = harness.Bench()
CONFIGS = ["cnn_resnet50_t5base", "cross_vitbase_robertabase"]


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_spec_is_the_port_state_dict(name):
    cfg = tiny.config(BENCH, name)
    model = BENCH.model(name)
    port = model.build(cfg, torch.device("cpu")).state_dict()
    spec = model.reference.weight_spec(cfg)
    assert [s[0] for s in spec] == list(port)
    for key, shape, *_ in spec:
        assert tuple(port[key].shape) == tuple(shape), key


def test_weights_repeat_from_the_seed():
    spec = BENCH.model(CONFIGS[1]).reference.weight_spec(
        tiny.config(BENCH, CONFIGS[1]))
    a = harness.make_weights(spec, 2 ** 31 + 5, torch.device("cpu"))
    b = harness.make_weights(spec, 2 ** 31 + 5, torch.device("cpu"))
    c = harness.make_weights(spec, 2 ** 31 + 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classification_layer.weight"],
                           c["classification_layer.weight"])


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_forward(name):
    """The port in float32 on the CPU (eval mode) against the reference on
    the same weights, images and questions: log-probs within 1e-4."""
    from t5_resnet_vqa_torch.data import HashTokenizer
    from t5_resnet_vqa_torch.eval.session import VQAInferenceSession

    cfg = tiny.config(BENCH, name)
    model = BENCH.model(name)
    answers = harness.answer_space(cfg["answers"])
    weights = harness.make_weights(model.reference.weight_spec(cfg), 11,
                                   torch.device("cpu"))
    session = VQAInferenceSession(
        model.build(cfg, torch.device("cpu")), weights, answers,
        family=model.FAMILY, batch_size=4, image_size=cfg["image_size"],
        device="cpu", tokenizer=HashTokenizer(pinned_words=answers))
    pool = generate.image_pool(4, cfg["image_size"], 11, torch.device("cpu"))
    session.collate.load_images = lambda paths: pool[[int(p) for p in paths]]
    bank = generate.QuestionBank(BENCH.mix("train_steps_b256")["questions"],
                                 11, size=4)
    batch = session._to_device(session._collate_chunk(
        [(str(i), q) for i, q in enumerate(bank.texts)]))
    got = session._predict(batch)
    want = model.reference.serve_logprobs(
        weights, cfg, torch.from_numpy(pool), bank.texts, answers, FP32)
    assert torch.allclose(got, want, atol=1e-4, rtol=0)


def test_reference_tokenizer_is_the_port_hash_tokenizer():
    from t5_resnet_vqa_torch.data import HashTokenizer

    answers = harness.answer_space(170)
    bank = generate.QuestionBank(BENCH.mix("train_steps_b256")["questions"],
                                 3, size=64)
    texts = [f"[Question] {q}" for q in bank.texts] + ["[Answer] answer007 ?"]
    ids, mask = HashTokenizer(pinned_words=answers)(texts, 16)
    want_ids, want_mask = inputs.hash_tokenize(texts, 16,
                                               inputs.pinned_ids(answers))
    assert np.array_equal(ids, want_ids) and np.array_equal(mask, want_mask)


@pytest.mark.parametrize("cell", ["cnn.serve", "cross.serve", "cross.train"])
def test_cell_runs_correct_on_the_cpu(cell):
    ctx = tiny.ctx(cell)
    outcome = run_cell(ctx)
    assert outcome["correct"], outcome["checks"]
    assert outcome["attempted"] > 0 and outcome["failed"] == 0
    assert all(np.isfinite(v) for v in outcome["metrics"].values())


def test_training_reference_in_passes_of_rows_is_the_whole_batch():
    """The training reference over a batch in passes of 2 rows, each pass
    drawing the batch's dropout masks and taking its rows, against the
    whole batch in one pass: the same steps to float64's rounding."""
    from gpu_bench.reference.nn import Precision

    name = CONFIGS[1]
    cfg = tiny.config(BENCH, name)
    ref = BENCH.model(name).reference
    weights = harness.make_weights(ref.weight_spec(cfg), 13,
                                   torch.device("cpu"))
    gen = torch.Generator().manual_seed(13)
    batches = [{"images": torch.randint(0, 256, (4, cfg["image_size"],
                                                 cfg["image_size"], 3),
                                        dtype=torch.uint8, generator=gen),
                "ids": torch.randint(3, 100, (4, cfg["question_len"]),
                                     generator=gen),
                "labels": torch.randint(0, cfg["answers"], (4,),
                                        generator=gen)} for _ in range(2)]
    torch.manual_seed(13)
    state = torch.get_rng_state()
    P = Precision("float64")
    whole = ref.train_steps(weights, cfg, batches, 10, P, state,
                            torch.float32)
    passes = ref.train_steps(weights, cfg, batches, 10, P, state,
                             torch.float32, rows=2)
    assert np.allclose(whole["losses"], passes["losses"], rtol=1e-12)
    largest = max(float(g.norm()) for g in whole["first_grad"].values())
    for k, g in whole["first_grad"].items():
        assert torch.allclose(passes["first_grad"][k], g, rtol=1e-9,
                              atol=1e-15), k
        # a weight whose gradient is zero but for rounding (the pooler's
        # bias under its softmax) moves under Adam by its rounding alone
        if float(g.norm()) >= 1e-9 * largest:
            assert torch.allclose(passes["change"][k], whole["change"][k],
                                  rtol=1e-9, atol=1e-15), k
