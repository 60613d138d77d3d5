"""The T5 encoder's CUDA-graph replay (``models/t5.py``, ``T5Encoder``) on a
card: a grad-free forward in ``eval()`` replays a graph captured on its
signature's second call, and equals the eager forward.

Every test needs a CUDA device (marker ``gpu``) and skips without one. The
file imports no JAX, so the machine with the card runs it on its own, past
the JAX-importing ``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_text_graph_gpu.py

* A T5-base-width encoder (12 layers, 768 wide, 12 heads) at B=256, S=16
  with padded rows, fp32 and bf16 autocast, under ``inference_mode`` and
  ``no_grad``: the replay equals the eager forward to the bit in fp32 and
  within ``LAYER_TOL`` of max|eager| under autocast
  (``tests/test_torch_family_gpu.py``'s bf16 tolerance).
* A replay's result is a copy: held across the next call, it is unchanged.
* ``text.graph_captures`` counts one graph per signature.
* A graph holds no memory of the common pool but its inputs and output:
  the capture stream's cuBLAS workspace lies in the graph's own pool.
* ``VQAInferenceSession.ask_batch`` on the CNN family gives the same top-3
  answers and probabilities with the graph as with the encoder hooked,
  which keeps it eager; the encoder's output inside the session equals the
  eager one to the bit. The probabilities are held within ``PROB_RTOL``:
  the family's fp32 forward is not bitwise repeatable on the card (two
  eager forwards of one batch differed by 4.8e-7 in a log-probability, the
  encoder's by nothing).
* A forward hook or pre-hook on the encoder or any module of it, a
  grad-enabled call and ``train()`` engage no graph.
"""

import contextlib

import numpy as np
import pytest
import torch

from t5_resnet_vqa_torch.data import HashTokenizer
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config, T5Encoder
from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.utils import profiling

pytestmark = pytest.mark.gpu

LAYER_TOL = {torch.float32: 0.0, torch.bfloat16: 3e-2}
PROB_RTOL = 1e-5
B, S = 256, 16


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def encoder(cuda):
    enc = T5Encoder(T5Config.t5_base())
    init_weights(enc, torch.Generator().manual_seed(0))
    return enc.to(cuda).eval()


def _questions(seed, batch=B):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(2, 32128, (batch, S), generator=g, dtype=torch.int32)
    lengths = torch.randint(3, S + 1, (batch,), generator=g)
    mask = (torch.arange(S)[None] < lengths[:, None]).to(torch.int32)
    return (ids * mask).cuda(), mask.cuda()


def _counters():
    got = profiling.counters()
    return {k: got.get(f"text.{k}", 0)
            for k in ("forwards", "graph_replays", "graph_captures")}


def _since(before):
    return {k: v - before[k] for k, v in _counters().items()}


def _context(dtype, grad):
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode() if grad == "inference_mode"
                        else torch.no_grad())
    if dtype != torch.float32:
        stack.enter_context(torch.autocast("cuda", dtype=dtype))
    return stack


@pytest.mark.parametrize("grad", ["inference_mode", "no_grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_equals_the_eager_forward(cuda, encoder, dtype, grad):
    encoder.drop_graphs()
    ids, mask = _questions(1)
    before = _counters()
    with _context(dtype, grad):
        want = encoder._eager(ids, mask)
        got = [encoder(ids, mask) for _ in range(3)]
    assert _since(before) == {"forwards": 3, "graph_replays": 2,
                              "graph_captures": 1}
    scale = float(want.float().abs().max())
    for out in got:
        assert out.dtype == want.dtype and out.shape == (B, S, 768)
        err = float((out.float() - want.float()).abs().max()) / scale
        assert err <= LAYER_TOL[dtype], err
    if dtype == torch.float32:
        assert all(torch.equal(out, want) for out in got)


def test_a_result_outlives_the_next_replay(cuda, encoder):
    encoder.drop_graphs()
    (ids1, mask1), (ids2, mask2) = _questions(2), _questions(3)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        for _ in range(2):                      # seen, then captured
            encoder(ids1, mask1)
        first = encoder(ids1, mask1)
        kept = first.clone()
        second = encoder(ids2, mask2)
        want = encoder._eager(ids2, mask2)
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert torch.equal(second, want)


def test_one_graph_per_signature(cuda, encoder):
    encoder.drop_graphs()
    before = _counters()
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        for _ in range(3):
            encoder(*_questions(4))
        assert _since(before)["graph_captures"] == 1
        for _ in range(3):
            encoder(*_questions(5, batch=B // 2))
        assert _since(before)["graph_captures"] == 2
        encoder(*_questions(6))
    assert _since(before) == {"forwards": 7, "graph_replays": 5,
                              "graph_captures": 2}
    assert len(encoder._graphs) == 2


def test_a_graph_holds_only_its_inputs_and_output(cuda, encoder):
    encoder.drop_graphs()
    ids, mask = _questions(8)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        encoder(ids, mask)                      # seen: runs eagerly
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        encoder(ids, mask)                      # captured
        encoder._eager(ids, mask)   # the current stream's cuBLAS workspace
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - before
    (entry,) = encoder._graphs.values()
    held = sum(t.untyped_storage().nbytes()
               for t in (entry.out, entry.ids, entry.mask))
    assert held <= grew <= held + 4096, (grew, held)


@pytest.mark.parametrize("why", ["hook", "pre_hook", "block_hook", "grad",
                                 "train"])
def test_what_keeps_the_forward_eager(cuda, encoder, why):
    encoder.drop_graphs()
    ids, mask = _questions(7)
    target = encoder.block[5].layer[1] if why == "block_hook" else encoder
    handle = (target.register_forward_pre_hook(lambda m, a: None)
              if why == "pre_hook" else
              target.register_forward_hook(lambda m, a, o: None)
              if why in ("hook", "block_hook") else None)
    if why == "train":
        encoder.train()
    grad = (contextlib.nullcontext() if why == "grad"
            else torch.inference_mode())
    before = _counters()
    try:
        with grad:
            for _ in range(3):
                encoder(ids, mask)
    finally:
        if handle is not None:
            handle.remove()
        encoder.eval()
    assert _since(before) == {"forwards": 3, "graph_replays": 0,
                              "graph_captures": 0}
    assert not encoder._graphs


ANSWERS = [f"answer{i}" for i in range(23)]
QUESTIONS = ["what is on the table", "how many chairs are in the room",
             "what is the color of the lamp", "what is behind the sofa",
             "what is to the left of the white cabinet near the door"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ask_batch_answers_as_the_eager_path(cuda, dtype):
    model = ResnetVQAModel(
        len(ANSWERS), vision_model_name="resnet18",
        t5_config=T5Config(num_layers=2),
        sga_config=AttentionConfig(hidden_size=768, num_heads=8, ff_size=1536),
        device=cuda)
    session = VQAInferenceSession(
        model, None, ANSWERS, batch_size=32, image_size=64,
        tokenizer=HashTokenizer(pinned_words=ANSWERS), compute_dtype=dtype,
        device=cuda)
    pool = np.random.default_rng(0).integers(0, 256, (16, 64, 64, 3),
                                             dtype=np.uint8)
    session.collate.load_images = lambda paths: pool[
        np.fromiter((int(p) for p in paths), np.int64)]
    requests = [(str(i % 16), QUESTIONS[i % len(QUESTIONS)])
                for i in range(80)]             # 2 full chunks and a part
    hook = model.lang_model.register_forward_pre_hook(lambda m, a: None)
    want = session.ask_batch(requests, top_k=3)
    hook.remove()
    before = _counters()
    for _ in range(3):
        got = session.ask_batch(requests, top_k=3)
        assert [r["top_answers"] for r in got] == \
            [r["top_answers"] for r in want]
        np.testing.assert_allclose([r["top_probs"] for r in got],
                                   [r["top_probs"] for r in want],
                                   rtol=PROB_RTOL, atol=0)
    counted = _since(before)
    assert counted["forwards"] == 9 and counted["graph_captures"] == 1
    assert counted["graph_replays"] == 8
    batch = session._to_device(session._collate_chunk(requests[:32]))
    args = batch["question_input_ids"], batch["question_attention_masks"]
    with torch.inference_mode(), session._autocast():
        assert torch.equal(model.lang_model(*args),
                           model.lang_model._eager(*args))
    assert _since(before)["graph_replays"] == 9
