"""Kimi-VL-A3B in the port (``models/kimi_vl.py``, ``ops/moe.py``,
``ops/mla.py``, the cached greedy loop of ``models/generation.py``, the
``kimi_vl`` family of the session) against the plain reference
``tests/kimi_vl_reference.py`` at tiny widths on the CPU, in float32: the
forward, prefill and cached decode at every step, the experts' dispatch,
the router's bias and scale, MoonViT's 2D rotation on a non-square grid,
``generate_batch`` end to end, the ranges and counters, and the
benchmark's copy of the reference (``gpu_bench/reference/kimi_vl.py``)
against this one."""

from __future__ import annotations

import collections
import copy
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import kimi_vl_reference as ref
from t5_resnet_vqa_torch.data import HashTokenizer, KimiVLCollate
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import (
    KimiVLConfig,
    build_kimi_vl,
    cached_greedy_generate,
)
from t5_resnet_vqa_torch.models import kimi_vl
from t5_resnet_vqa_torch.ops import moe as moe_op
from t5_resnet_vqa_torch.utils import profiling

TEXT = dict(vocab_size=163840, hidden_size=32, intermediate_size=48,
            moe_intermediate_size=16, num_hidden_layers=3,
            num_attention_heads=2, n_shared_experts=2, n_routed_experts=8,
            num_experts_per_tok=3, routed_scaling_factor=2.446,
            first_k_dense_replace=1, kv_lora_rank=16, q_lora_rank=None,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
            rms_norm_eps=1e-5, rope_theta=800000.0, scoring_func="sigmoid",
            n_group=1, topk_group=1, norm_topk_prob=True)
VISION = dict(patch_size=4, hidden_size=16, num_layers=2, num_heads=2,
              mlp_dim=24, pos_emb_size=4, rope_theta=10000.0, merge=2,
              layer_norm_eps=1e-5)
PAD = KimiVLCollate.SPECIAL_TOKENS["media_pad"]
CFG = {"text": TEXT, "vision": VISION, "media_placeholder_token_id": PAD}
IMAGE = (16, 24)          # a 4 x 6 grid of patches (the table is 4 x 4)
TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    return ref.draw(CFG, 7)


def _model(weights):
    model = build_kimi_vl(KimiVLConfig.from_dict(TEXT, VISION, PAD),
                          dtype=torch.float32)
    model.load_state_dict(weights, strict=True, assign=True)
    return model.eval()


def _images(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *IMAGE, 3), dtype=torch.uint8,
                         generator=g)


def _prompts():
    """Two prompts of their own lengths (6 image tokens each), padded on
    the right."""
    rows = [[11, 12] + [PAD] * 6 + [13, 14, 15, 16],
            [11, 12] + [PAD] * 6 + [17, 18]]
    ids = torch.full((2, 12), 5, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r)
    return rows, ids, torch.tensor([len(r) for r in rows])


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_state_dict_names_the_reference_weights(weights):
    model = build_kimi_vl(KimiVLConfig.from_dict(TEXT, VISION, PAD),
                          dtype=torch.float32)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in weights.items()}


def test_forward_matches_the_reference(weights):
    model = _model(weights)
    rows, ids, _ = _prompts()
    images = _images(2)
    with torch.inference_mode():
        got = model(ids, images)
    for i, r in enumerate(rows):
        want = ref.logits(weights, CFG, r, images[i])
        assert _rel(got[i, :len(r)], want) < TOL


def _cached_against_reference(model, weights, steps=4):
    rows, ids, lengths = _prompts()
    images = _images(2)
    with torch.inference_mode():
        tokens, top, values = cached_greedy_generate(
            model, ids, lengths, images, max_answer_length=steps, top_k=5)
    worst = 0.0
    for i, r in enumerate(rows):
        want = ref.logits(weights, CFG, r + tokens[i, :-1].tolist(),
                          images[i]).log_softmax(-1)[len(r) - 1:]
        assert torch.equal(top[i, :, 0], tokens[i])
        worst = max(worst, float((values[i] - want.gather(1, top[i]))
                                 .abs().max()))
    return worst


def test_prefill_then_cached_decode_matches_the_full_forward(weights):
    assert _cached_against_reference(_model(weights), weights) < TOL


def test_a_cache_missing_its_newest_position_fails(weights, monkeypatch):
    real = kimi_vl.mla_decode

    def short(q, cache, positions, latent, scale):
        return real(q, cache, positions - 1, latent, scale)

    monkeypatch.setattr(kimi_vl, "mla_decode", short)
    assert _cached_against_reference(_model(weights), weights) > 1e-3


def _moe_inputs(seed=3, n=40, d=32, experts=8, width=16):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    return (r(n, d), r(experts, d) * 0.3, r(experts) * 0.1,
            r(experts, 2 * width, d) * 0.2, r(experts, d, width) * 0.2,
            (r(2 * width, d) * 0.2, r(2 * width, d) * 0.2,
             r(d, 2 * width) * 0.2))


def test_moe_dispatch_matches_a_dense_per_token_loop():
    x, gate, bias, gate_up, down, shared = _moe_inputs()
    got = moe_op.moe(x, gate, bias, gate_up, down, shared, 3, 2.446)
    W = {"m.gate.weight": gate, "m.gate.e_score_correction_bias": bias,
         "m.experts.gate_up_proj": gate_up, "m.experts.down_proj": down,
         "m.shared_experts.gate_proj.weight": shared[0],
         "m.shared_experts.up_proj.weight": shared[1],
         "m.shared_experts.down_proj.weight": shared[2]}
    t = dict(TEXT, moe_intermediate_size=16, num_experts_per_tok=3)
    assert _rel(got, ref.moe(W, "m.", t, x)) < TOL


def test_the_bias_changes_the_choice_and_not_the_weights():
    x, gate, _, *_ = _moe_inputs()
    zero = torch.zeros(gate.shape[0])
    chosen0, w0 = moe_op.route(x, gate, zero, 3, 1.0)
    bias = torch.zeros_like(zero)
    bias[5] = 10.0                                 # expert 5 always chosen
    chosen1, w1 = moe_op.route(x, gate, bias, 3, 1.0)
    assert (chosen1 == 5).any(dim=1).all()
    assert not (chosen0 == 5).any(dim=1).all()
    scores = torch.sigmoid(x @ gate.t())
    picked = scores.gather(1, chosen1)
    assert torch.allclose(w1, picked / picked.sum(1, keepdim=True),
                          rtol=1e-6)


def test_weights_normalised_then_scaled():
    x, gate, bias, *_ = _moe_inputs()
    chosen, w = moe_op.route(x, gate, bias, 3, 2.446)
    assert torch.allclose(w.sum(1), torch.full((len(x),), 2.446), rtol=1e-6)
    scores = torch.sigmoid(x @ gate.t()).gather(1, chosen)
    ratio = w / scores
    assert torch.allclose(ratio, ratio[:, :1].expand_as(ratio), rtol=1e-6)
    assert torch.equal(chosen, (torch.sigmoid(x @ gate.t()) + bias)
                       .topk(3, dim=1).indices)


def test_rope2d_on_a_non_square_grid():
    gh, gw, heads, d = 3, 5, 2, 8
    x = torch.randn(gh * gw, heads, d, generator=torch.Generator()
                    .manual_seed(4))
    cos, sin = kimi_vl.rope2d_tables(gh, gw, d, 10000.0, "cpu")
    got = kimi_vl.apply_rope2d(x.transpose(0, 1)[None], cos, sin)[0]
    want = ref._rope2d(x, gh, gw, 10000.0)
    assert torch.allclose(got.transpose(0, 1), want, atol=1e-6)
    # a patch's row and column turn different pairs: swap them, and the
    # grid's transpose does not give the same rotation
    other = ref._rope2d(x, gw, gh, 10000.0)
    assert not torch.allclose(want, other, atol=1e-3)


def _session(weights, batch=3):
    session = VQAInferenceSession(
        build_kimi_vl(KimiVLConfig.from_dict(TEXT, VISION, PAD),
                      dtype=torch.float32),
        weights, [], family="kimi_vl", batch_size=batch, image_size=IMAGE,
        device="cpu", tokenizer=HashTokenizer(vocab_size=163840))
    pool = _images(4, seed=9).numpy()
    session.collate.load_images = lambda paths: pool[[int(p) for p in paths]]
    return session, pool


QUESTIONS = [("0", "what is on the table"),
             ("1", "what is to the left of the red chair in the room"),
             ("2", "how many books")]


def test_generate_batch_end_to_end(weights):
    session, pool = _session(weights, batch=2)     # two chunks, one padded
    with pytest.warns(UserWarning, match="hash fallback"):
        records = session.generate_batch(QUESTIONS, max_answer_length=3)
    assert len(records) == 3
    collate = session.collate
    for (image, question), rec in zip(QUESTIONS, records):
        ids = collate.prefix + collate._words(
            [question], collate.max_question_tokens)[0] + collate.suffix
        lp = rec["token_logprobs"]
        assert len(rec["token_ids"]) == len(lp["ids"]) == len(lp["values"])
        want = ref.logits(weights, CFG, ids + rec["token_ids"][:-1],
                          torch.from_numpy(pool[int(image)]))
        want = want.log_softmax(-1)[len(ids) - 1:]
        top = torch.tensor(lp["ids"])
        assert top[:, 0].tolist() == rec["token_ids"]
        assert torch.allclose(torch.tensor(lp["values"]),
                              want.gather(1, top), atol=TOL)
    with pytest.raises(ValueError, match="greedily"):
        session.generate_batch(QUESTIONS, num_beams=3)


def test_the_session_prompt_follows_the_model_config(weights):
    ids = {k: v for k, v in KimiVLCollate.SPECIAL_TOKENS.items()
           if k != "media_pad"}
    ids.update(im_user=100, im_end=101)
    config = KimiVLConfig.from_dict(TEXT, VISION, PAD, ids,
                                    max_question_tokens=4)
    session = VQAInferenceSession(
        build_kimi_vl(config, dtype=torch.float32), weights, [],
        family="kimi_vl", batch_size=2, image_size=IMAGE, device="cpu",
        tokenizer=HashTokenizer(vocab_size=163840))
    collate = session.collate
    assert collate.prefix[0] == 100 and collate.suffix[0] == 101
    assert collate.eos == 101 and PAD in collate.prefix
    assert collate.length == len(collate.prefix) + 4 + len(collate.suffix)
    collate.load_images = lambda paths: _images(len(paths)).numpy()
    batch = collate([("0", QUESTIONS[1][1])], 2)
    assert batch["lengths"].tolist() == [collate.length] * 2


def _trace_names(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(
        e["name"][len(profiling.PREFIX):] for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e["name"].startswith(profiling.PREFIX))


def test_ranges_and_counters(weights, tmp_path):
    model = _model(weights)
    _, ids, lengths = _prompts()
    images = _images(2)
    profiling.reset_counters()
    steps = 3
    with torch.inference_mode():
        names = _trace_names(tmp_path, lambda: cached_greedy_generate(
            model, ids, lengths, images, max_answer_length=steps))
    layers, moe_layers = 3, 2
    assert names["model.vision"] == 1 and names["model.prefill"] == 1
    assert names["model.decode"] == steps - 1
    assert names["op.mla"] == layers
    assert names["op.mla_decode"] == layers * (steps - 1)
    assert names["op.moe"] == moe_layers * steps
    got = profiling.counters()
    k, B, S = TEXT["num_experts_per_tok"], *ids.shape
    rows = moe_layers * (B * S * k + (steps - 1) * B * k)
    assert got["generate.prefills"] == 1
    assert got["generate.steps"] == steps - 1
    assert got["moe.calls"] == moe_layers * steps
    assert got["moe.rows"] == rows
    # the busiest expert of a call takes at least an even share of it
    assert rows / TEXT["n_routed_experts"] <= got["moe.busiest_rows"] < rows


def test_the_benchmark_reference_agrees(weights):
    from gpu_bench.reference import kimi_vl as bench_ref
    from gpu_bench.reference.nn import FP32

    cfg = dict(copy.deepcopy(TEXT), vision=VISION,
               media_placeholder_token_id=PAD,
               max_question_tokens=23,
               special_tokens=KimiVLCollate.SPECIAL_TOKENS)
    spec = bench_ref.weight_spec(cfg)
    assert [s[0] for s in spec] == list(weights)
    assert all(tuple(s[1]) == tuple(weights[s[0]].shape) for s in spec)
    collate = KimiVLCollate(HashTokenizer(vocab_size=163840), IMAGE, 4, 2)
    questions = [q for _, q in QUESTIONS[:2]]
    tokens = [[101, 202, 303], [404, 505]]
    images = _images(2, seed=5)
    got, routes, gaps = bench_ref.generate_logprobs(
        weights, cfg, images, questions, tokens, FP32)
    assert gaps == [0.0, 0.0]
    for i, q in enumerate(questions):
        ids = bench_ref.prompt_ids(cfg, q, collate.image_tokens)
        assert ids == collate.prefix + collate._words(
            [q], 23)[0] + collate.suffix
        want = ref.logits(weights, CFG, ids + tokens[i][:-1], images[i])
        want = want.log_softmax(-1)[len(ids) - 1:]
        assert torch.allclose(got[i], want, atol=TOL, rtol=0)
        # a route a sparse layer per position it runs
        assert [tuple(r.shape) for r in routes[i]] == \
            [(len(ids) + len(tokens[i]) - 1, 3)] * 2
    # following its own routes changes nothing; another expert at one
    # position is read as a gap and moves the log-probs
    again, _, gaps = bench_ref.generate_logprobs(
        weights, cfg, images, questions, tokens, FP32, routes)
    assert gaps == [0.0, 0.0]
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    other = [[r.clone() for r in pair] for pair in routes]
    row = other[1][1][-1]
    row[0] = next(e for e in range(8) if e not in row.tolist())
    moved, _, gaps = bench_ref.generate_logprobs(
        weights, cfg, images, questions, tokens, FP32, other)
    assert gaps[0] == 0.0 and gaps[1] > 0.0
    assert torch.equal(moved[0], got[0])
    assert not torch.allclose(moved[1][-1], got[1][-1], atol=1e-4)


def test_recorded_routes_are_the_routes_the_reference_takes(weights):
    from gpu_bench.reference import kimi_vl as bench_ref
    from gpu_bench.reference.nn import FP32

    model = _model(weights)
    collate = KimiVLCollate(HashTokenizer(vocab_size=163840), IMAGE, 4, 2)
    pool = _images(2, seed=5).numpy()
    collate.load_images = lambda paths: pool[[int(p) for p in paths]]
    batch = collate(QUESTIONS[:2], 2)
    steps = 3
    with torch.inference_mode(), moe_op.recorded_routes() as recorded:
        tokens, ids, values = cached_greedy_generate(
            model, torch.from_numpy(batch["input_ids"]),
            torch.from_numpy(batch["lengths"]),
            torch.from_numpy(batch["pixel_values"]), steps)
    B, S = batch["input_ids"].shape
    # the prefill's 2 sparse layers over every padded row, then each step's
    assert [tuple(r.shape) for r in recorded] == \
        [(B * S, 3)] * 2 + [(B, 3)] * 2 * (steps - 1)
    routes = [[torch.cat([recorded[l].view(B, S, 3)[i, :n]]
                         + [recorded[2 * s + l][i:i + 1]
                            for s in range(1, steps)])
               for l in range(2)]
              for i, n in enumerate(batch["lengths"].tolist())]
    cfg = dict(copy.deepcopy(TEXT), vision=VISION,
               media_placeholder_token_id=PAD, max_question_tokens=23,
               special_tokens=KimiVLCollate.SPECIAL_TOKENS)
    questions = [q for _, q in QUESTIONS[:2]]
    got, own, gaps = bench_ref.generate_logprobs(
        weights, cfg, torch.from_numpy(pool), questions, tokens.tolist(),
        FP32, routes)
    assert gaps == [0.0, 0.0]
    for i in range(2):
        assert torch.allclose(got[i].gather(1, ids[i]), values[i], atol=TOL)
    # in float32 the reference's own choices are the program's
    _, own, _ = bench_ref.generate_logprobs(
        weights, cfg, torch.from_numpy(pool), questions, tokens.tolist(),
        FP32)
    assert all(torch.equal(a.sort(-1).values, b.sort(-1).values)
               for pair, mine in zip(routes, own) for a, b in zip(pair, mine))
