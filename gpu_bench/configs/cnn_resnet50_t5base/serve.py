"""``cnn_resnet50_t5base`` served: the counts the metrics need for one
pair's forward (model FLOPs, kernel 1's and kernel 2's call shapes) and
the reference's served log-probs."""

from __future__ import annotations

from typing import Dict, List, Mapping

from gpu_bench import harness

model = harness.beside(__file__, "model")
serve_logprobs = model.reference.serve_logprobs


def bottleneck_blocks(cfg: Mapping) -> List[Dict]:
    """The blocks of one forward that kernel 2 runs, per pair."""
    return model.tower(cfg)[2]


def attention_calls(cfg: Mapping) -> List[Dict]:
    """Kernel 1's forward calls per pair: the SGA's, six per forward."""
    s, L = cfg["sga"], cfg["question_len"]
    tokens = model.tower(cfg)[0]
    D = cfg["hidden_size"] // s["num_heads"]
    calls = []
    for b in range(s["blocks"]):
        calls.append({"heads": s["num_heads"], "sq": L, "sk": L, "d": D,
                      "stats": False})
        calls.append({"heads": s["num_heads"], "sq": L,
                      "sk": tokens if b == 0 else L, "d": D, "stats": False})
    return calls


def flops_per_sample(cfg: Mapping) -> float:
    """Model FLOPs (2 per multiply-add of every product) of one pair's
    forward."""
    tokens, macs, _ = model.tower(cfg)
    hidden, L, t, s = (cfg["hidden_size"], cfg["question_len"], cfg["t5"],
                       cfg["sga"])
    c5 = cfg["resnet"]["widths"][-1] * cfg["resnet"]["expansion"]
    macs += tokens * hidden * c5 * 9                    # the projection
    inner = t["num_heads"] * t["d_kv"]
    macs += t["num_layers"] * (L * (4 * t["d_model"] * inner
                                    + 2 * t["d_model"] * t["d_ff"])
                               + 2 * L * L * inner)
    for b in range(s["blocks"]):
        sk = tokens if b == 0 else L
        macs += 4 * L * hidden * hidden + 2 * L * L * hidden     # mhatt1
        macs += (2 * L + 2 * sk) * hidden * hidden \
            + 2 * L * sk * hidden                                 # mhatt2
        macs += 2 * L * hidden * s["ff_size"]                     # ffn
    macs += L * hidden + hidden * cfg["answers"]        # pooler, classifier
    return 2.0 * macs
