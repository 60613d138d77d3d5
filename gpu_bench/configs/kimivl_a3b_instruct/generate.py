"""``kimivl_a3b_instruct`` generating answers: the counts the metrics need
for one pair (model FLOPs) and for the two ops that the program's ranges
time (``op.moe``, ``op.mla_decode``), and the reference's log-probs over
the program's own tokens.

A pair is its image (``image_tokens``: 414 from 1656 patches at the
cell's 480 x 640), its prompt of ``prompt_length`` positions (the padded
length every prompt is run at, 448: the pads' work is counted, at most 18
positions), the prefill's one token and ``answer_tokens - 1`` cached
decode steps. A traffic mix's ``shape`` may give another image size or
``answer_tokens``; the loop lays it over the configuration. Two operations
a multiply-add; weights and activations of 2 bytes (bf16)."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from gpu_bench import harness, peaks

model = harness.beside(__file__, "model")
generate_logprobs = model.reference.generate_logprobs
BF16 = 2


def image_tokens(cfg: Mapping) -> int:
    return model.reference.image_tokens_of(
        cfg["vision"], cfg["image_height"], cfg["image_width"])


def prompt_length(cfg: Mapping) -> int:
    """The chat turn's parts around the image tokens and the question's
    most tokens."""
    return len(model.reference.prompt_ids(cfg, "", image_tokens(cfg))) \
        + cfg["max_question_tokens"]


def _vision_macs(cfg: Mapping) -> float:
    v = cfg["vision"]
    d, p = v["hidden_size"], v["patch_size"]
    S = image_tokens(cfg) * v["merge"] ** 2
    m = d * v["merge"] ** 2
    layer = S * (4 * d * d + 2 * d * v["mlp_dim"]) + 2 * S * S * d
    return S * 3 * p * p * d + v["num_layers"] * layer \
        + image_tokens(cfg) * (m * m + m * cfg["hidden_size"])


def _ffn_macs(cfg: Mapping, layer: int) -> float:
    """Per token."""
    d = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 3 * d * cfg["intermediate_size"]
    w = cfg["moe_intermediate_size"]
    return d * cfg["n_routed_experts"] \
        + 3 * d * w * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])


def _mla_dims(cfg: Mapping):
    return (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def _prefill_macs(cfg: Mapping) -> float:
    d, L = cfg["hidden_size"], prompt_length(cfg)
    H, nope, rope, vd, r = _mla_dims(cfg)
    proj = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd) \
        + H * vd * d
    attn = H * L * (L + 1) / 2 * (nope + rope + vd)
    return sum(L * (proj + _ffn_macs(cfg, i)) + attn
               for i in range(cfg["num_hidden_layers"])) \
        + d * cfg["vocab_size"]


def _decode_macs(cfg: Mapping, step: int) -> float:
    """One token at decode step ``step`` (1..), which attends to
    ``prompt_length + step`` cache positions through the folded
    projections."""
    d = cfg["hidden_size"]
    H, nope, rope, vd, r = _mla_dims(cfg)
    T = prompt_length(cfg) + step
    attn = d * H * (nope + rope) + d * (r + rope) + H * nope * r \
        + H * T * (2 * r + rope) + H * r * vd + H * vd * d
    return sum(attn + _ffn_macs(cfg, i)
               for i in range(cfg["num_hidden_layers"])) \
        + d * cfg["vocab_size"]


def flops_per_sample(cfg: Mapping) -> float:
    """Model FLOPs of one pair: MoonViT and the projector, the prefill
    over the padded prompt, the decode steps."""
    steps = range(1, cfg["answer_tokens"])
    return 2.0 * (_vision_macs(cfg) + _prefill_macs(cfg)
                  + sum(_decode_macs(cfg, t) for t in steps))


def moe_call(cfg: Mapping, rows: float) -> tuple:
    """(bytes, operations) of one sparse layer over ``rows`` routed pairs
    (``num_experts_per_tok`` a token): every routed expert's weights read
    once (a decode step's 384 pairs leave one of 64 experts empty with
    probability about e^-6; counted as read), the shared expert's and the
    router's, the rows in and out; the routed, shared and router
    products."""
    d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    tokens = rows / k
    weights = 3 * d * w * (E + cfg["n_shared_experts"]) + E * d
    nbytes = (weights + 2 * tokens * d) * BF16
    flops = 2.0 * (rows * 3 * d * w
                   + tokens * (3 * d * w * cfg["n_shared_experts"] + d * E))
    return nbytes, flops


def moe_bound_s(cfg: Mapping, counts: Mapping[str, int], batch: int
                ) -> Optional[float]:
    """The least seconds of the sparse layers of a stretch, from the
    program's counters over it (``moe.calls``, ``moe.rows``,
    ``generate.prefills``, ``generate.steps``): each decode step's layers
    route ``batch`` tokens, the prefills' layers share the other rows.
    None where the counters do not add up to that."""
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    k = cfg["num_experts_per_tok"]
    calls, rows = counts.get("moe.calls", 0), counts.get("moe.rows", 0)
    prefill_calls = layers * counts.get("generate.prefills", 0)
    decode_calls = layers * counts.get("generate.steps", 0)
    if not prefill_calls or calls != prefill_calls + decode_calls:
        return None
    prefill_rows = (rows - decode_calls * batch * k) / prefill_calls
    return prefill_calls * peaks.bound_s(*moe_call(cfg, prefill_rows)) \
        + decode_calls * peaks.bound_s(*moe_call(cfg, batch * k))


def mla_decode_calls(cfg: Mapping) -> List[Dict]:
    """The decode attention cores of one generated answer: each layer's at
    each decode step, over the cache positions the step reads."""
    return [{"positions": prompt_length(cfg) + t}
            for t in range(1, cfg["answer_tokens"])
            for _ in range(cfg["num_hidden_layers"])]


def mla_decode(cfg: Mapping):
    """``bound(call, batch)``: (bytes, operations) of one decode attention
    core: the latent cache read (``kv_lora_rank + qk_rope_head_dim``
    values a position), the folded query read and the latent output
    written; scores and the weighted sum."""
    H, _, rope, _, r = _mla_dims(cfg)

    def bound(call: Mapping, batch: int):
        T = call["positions"]
        nbytes = batch * (T * (r + rope) + H * (r + rope) + H * r) * BF16
        return nbytes, 2.0 * batch * H * T * (2 * r + rope)

    return bound
