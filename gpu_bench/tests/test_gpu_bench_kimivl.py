"""``kimivl.generate``: the counts at the cell's shapes against the
figures they were sized from, the weight spec against the port's
``state_dict`` at the published widths, and whole runs of the cell at a
tiny width of its own on the CPU (float32 on both sides), the control
beside the program."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from gpu_bench import harness, peaks
from gpu_bench.run import Ctx, run_cell

BENCH = harness.Bench()
CELL = "kimivl.generate"
MIX = BENCH.mix("generate_closed_b64_x64")
CFG = BENCH.config("kimivl_a3b_instruct")
MODEL = BENCH.model("kimivl_a3b_instruct")
PART = BENCH.part("kimivl_a3b_instruct", "generate")
# float32 on both sides: sums in another order
TINY_LIMITS = {"gen_top1_gap": 1e-4, "prefill_lp_rms": 1e-4,
               "decode_lp_rms": 1e-4, "route_gap": 1e-4}


def tiny_config() -> dict:
    cfg = copy.deepcopy(CFG)
    cfg.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
               num_experts_per_tok=3, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, compute_dtype="float32")
    cfg["vision"].update(patch_size=4, hidden_size=32, num_layers=2,
                         num_heads=4, mlp_dim=48, pos_emb_size=8)
    return cfg


def tiny_ctx(seed: int, control: bool = False) -> Ctx:
    mix = copy.deepcopy(MIX)
    mix.update(session_batch=4, requests_per_call=4, image_pool=8,
               warmup_calls=1, check_requests=6, check_block=4,
               trace_calls=1)
    mix["shape"] = {"image_height": 16, "image_width": 24}
    return Ctx(BENCH, CELL, seed, 0.3, False, torch.device("cpu"),
               cfg=tiny_config(), mix=mix, control=control,
               limits=TINY_LIMITS)


def test_flops_per_pair():
    vision = 1656 * 2 * (4 * 1152 ** 2 + 2 * 1152 * 4304) * 27 \
        + 27 * 2 * 2 * 1656 ** 2 * 1152
    assert vision == pytest.approx(1.70e12, rel=0.01)
    flops = PART.flops_per_sample(CFG)
    # MoonViT ~1.73 T, the prefill ~2.0 T (448 positions x 2 x 2.25 B
    # active), 4 decode steps ~0.02 T
    assert 3.70e12 < flops < 3.85e12
    assert 2 * PART._vision_macs(CFG) == pytest.approx(1.73e12, rel=0.01)
    assert 2 * PART._prefill_macs(CFG) == pytest.approx(
        448 * 2 * 2.25e9, rel=0.02)


def test_moe_and_decode_attention_bounds():
    # a prefill layer: 64 x 448 tokens, 6 experts each, compute-bound
    rows = 64 * 448 * 6
    nbytes, flops = PART.moe_call(CFG, rows)
    assert flops == pytest.approx(
        2 * 64 * 448 * (6 * 3 + 2 * 3) * 2048 * 1408, rel=0.01)
    assert 1e3 * peaks.bound_s(nbytes, flops) == pytest.approx(4.02, abs=0.01)
    # a decode layer reads every expert: 26 of them ~29.7 GB, ~8.9 ms
    nbytes, flops = PART.moe_call(CFG, 64 * 6)
    assert 26 * nbytes == pytest.approx(29.7e9, rel=0.01)
    assert 26e3 * peaks.bound_s(nbytes, flops) == pytest.approx(8.87,
                                                                abs=0.02)
    counts = {"moe.calls": 26 * 5, "moe.rows": 26 * (rows + 4 * 384),
              "generate.prefills": 1, "generate.steps": 4}
    assert PART.moe_bound_s(CFG, counts, 64) == pytest.approx(
        26 * peaks.bound_s(*PART.moe_call(CFG, rows))
        + 104 * peaks.bound_s(*PART.moe_call(CFG, 384)))
    counts["moe.calls"] += 1
    assert PART.moe_bound_s(CFG, counts, 64) is None
    # the decode attention: 27 layers x 4 steps, the latent cache read
    calls = PART.mla_decode_calls(CFG)
    assert len(calls) == 108
    assert {c["positions"] for c in calls} == {449, 450, 451, 452}
    nbytes, _ = PART.mla_decode(CFG)(calls[0], 64)
    assert nbytes == 64 * (449 * 576 + 16 * 576 + 16 * 512) * 2
    # the latent cache of a call: 64 x 452 x 27 x 576 values, 0.9 GB
    assert 64 * 452 * 27 * 576 * 2 == pytest.approx(0.9e9, rel=0.01)


def test_published_widths_and_prompt():
    from t5_resnet_vqa_torch.data import HashTokenizer, KimiVLCollate

    assert CFG["reduced"] == []
    assert (CFG["num_hidden_layers"], CFG["n_routed_experts"],
            CFG["vocab_size"]) == (27, 64, 163840)
    size = (CFG["image_height"], CFG["image_width"])
    config = MODEL.build(CFG).config
    collate = KimiVLCollate(
        HashTokenizer(vocab_size=CFG["vocab_size"]), size,
        max_question_tokens=config.max_question_tokens,
        special_tokens=dict(config.special_tokens))
    assert collate.image_tokens == PART.image_tokens(CFG) == \
        MODEL.reference.image_tokens_of(CFG["vision"], *size) == 414
    assert collate.length == PART.prompt_length(CFG) == 448
    assert collate.padded_size == \
        MODEL.reference.padded_size(CFG["vision"], *size) == (504, 644)
    # the program's default ids are the configuration's
    specials = {k: KimiVLCollate.SPECIAL_TOKENS[k]
                for k in CFG["special_tokens"]}
    assert specials == CFG["special_tokens"] == dict(config.special_tokens)
    question = "what is found between the box and the lamp in the room"
    assert MODEL.reference.prompt_ids(CFG, question, 414) == \
        collate.prefix + collate._words([question], 23)[0] + collate.suffix


def test_weight_spec_is_the_port_state_dict():
    port = MODEL.build(CFG).state_dict()           # on meta: no memory
    spec = MODEL.reference.weight_spec(CFG)
    assert [s[0] for s in spec] == list(port)
    for key, shape, *_ in spec:
        assert tuple(port[key].shape) == tuple(shape), key
    params = sum(int(np.prod(s[1])) for s in spec)
    assert params == pytest.approx(16.41e9, rel=0.001)


def test_a_weight_drawn_again_alone_is_the_same():
    cfg = tiny_config()
    spec = MODEL.reference.weight_spec(cfg)
    lazy = MODEL.LazyWeights(cfg, 2 ** 31 + 3, torch.device("cpu"))
    held = MODEL.program_weights(cfg, 2 ** 31 + 3, torch.device("cpu"))
    name = spec[17][0]
    assert torch.equal(lazy[name], held[name])
    assert not torch.equal(
        MODEL.LazyWeights(cfg, 2 ** 31 + 4, torch.device("cpu"))[name],
        held[name])


def test_cell_runs_correct_on_the_cpu_and_the_control_reads_past_it():
    ctx = tiny_ctx(2 ** 31 + 77, control=True)
    outcome = run_cell(ctx)
    assert outcome["correct"], outcome["checks"]
    assert outcome["attempted"] > 0 and outcome["failed"] == 0
    assert all(np.isfinite(v) for v in outcome["metrics"].values())
    program, control = ctx.readings["program"], ctx.readings["control"]
    assert all(control[k] > 10 * program[k] for k in
               ("prefill_lp_rms", "decode_lp_rms"))
    assert any(control[k] > TINY_LIMITS[k] for k in TINY_LIMITS)
    # float32 on both sides: the same experts, and the call made again
    # answers as served
    assert program["route_gap"] == 0.0 and program["rerun_mismatch"] == 0


def test_a_program_that_routes_otherwise_is_not_correct(monkeypatch):
    from t5_resnet_vqa_torch.ops import moe as moe_op

    real = moe_op.route

    def no_bias(x, gate, bias, top_k, scale):
        return real(x, gate, torch.zeros_like(bias), top_k, scale)

    monkeypatch.setattr(moe_op, "route", no_bias)
    ctx = tiny_ctx(2 ** 31 + 77)
    outcome = run_cell(ctx)
    # the reference takes the program's experts: only the gap sees it
    assert not outcome["correct"]
    assert outcome["checks"]["route_gap"]["value"] > 1e-3
    assert outcome["checks"]["decode_lp_rms"]["value"] < 1e-4
