"""``serve_closed``: closed-loop clients of the program's serving session
(``VQAInferenceSession.ask_batch``), one call after another.

Set-up builds the session on the benchmark's weights, hands its collate
the run's images, and warms up with calls of the window's shape. The
window then makes calls for ``--seconds``: each carries the mix's
``requests_per_call`` pairs (chunks of ``session_batch``, dispatched ahead
as the session does) and is timed on the host clock around the call,
which returns every answer.

End-to-end: ``serve_pairs_per_s`` (every pair answered in the window over
the window's seconds), ``serve_p95_ms`` (the 95th percentile of the
latencies of all calls of the window), ``peak_device_mib``, ``setup_s``.

``correct``: once the window has closed and the program is freed, a
sample of the answered pairs drawn from the seed is run through the plain
reference in float32 in blocks, and two numbers are compared with their
limits (``numbers``): the widest gap in log-probability by which a served
answer lies below the reference's best answer of its pair, and the
differences between served probabilities and the reference's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np

from gpu_bench import faults, generate, harness
from gpu_bench.reference.nn import FP32, Precision, no_tf32

MODE = "serve"


def _session(ctx, answers, weights):
    import torch

    from t5_resnet_vqa_torch.data import HashTokenizer
    from t5_resnet_vqa_torch.eval.session import VQAInferenceSession

    cfg, mix = ctx.cfg, ctx.mix
    model = ctx.model.build(cfg, ctx.device)
    return VQAInferenceSession(
        model, weights, answers, family=ctx.model.FAMILY,
        batch_size=mix["session_batch"], image_size=cfg["image_size"],
        uint8_wire=True, compute_dtype=getattr(torch, cfg["compute_dtype"]),
        device=ctx.device, tokenizer=HashTokenizer(pinned_words=answers))


def _instrument(ctx, session) -> None:
    """The traced run's spans: the session's host steps, the model's
    forward, and each block that kernel 2 runs."""
    t = ctx.tracer
    for attr, name in (("_collate_chunk", "collate"), ("_to_device", "copy"),
                       ("_decode", "decode"), ("ask_batch", "ask_batch")):
        t.wrap(session, attr, name)
    t.hook_module(session.model, "forward")
    vision = getattr(session.model, "vision_model", None)
    # a block runs either through ``forward_fused`` (kernel 2), which the
    # tower calls directly and which so passes by the module's hooks, or
    # through its module forward: one span each, never both at once
    for stage in getattr(vision, "fused_stages", ()):
        for block in getattr(vision, f"layer{stage + 1}"):
            t.wrap(block, "forward_fused", "bottleneck")
            t.hook_module(block, "bottleneck")


def run(ctx) -> Dict:
    import torch

    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    answers = harness.answer_space(cfg["answers"])
    index = {a: i for i, a in enumerate(answers)}
    spec = ctx.model.reference.weight_spec(cfg)
    weights = harness.make_weights(spec, seed, device)
    session = _session(ctx, answers, weights)
    del weights
    ctx.log("session built on the benchmark's weights")
    pool = generate.image_pool(mix["image_pool"], cfg["image_size"], seed,
                               device)
    session.collate.load_images = lambda paths: pool[
        np.fromiter((int(p) for p in paths), np.int64)]
    bank = generate.QuestionBank(mix["questions"], seed)
    faults.apply(ctx.fault, session=session)
    _instrument(ctx, session)
    top_k = mix["top_k"]

    def call(j):
        images, questions = generate.serve_call(mix, seed, j, len(pool), bank)
        reqs = [(str(i), bank.texts[q]) for i, q in zip(images, questions)]
        return images, questions, session.ask_batch(reqs, top_k=top_k)

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ctx.log(f"{len(pool)} images, {len(bank)} questions")
    for j in range(mix["warmup_calls"]):
        call(-1 - j)
    ctx.settle()
    ctx.tracer.reset()
    setup_s = time.perf_counter() - ctx.t0

    latencies, done, attempted, failed = [], [], 0, 0
    t_start = time.perf_counter()
    j = 0
    while time.perf_counter() - t_start < ctx.seconds:
        t0 = time.perf_counter()
        attempted += mix["requests_per_call"]
        try:
            images, questions, results = call(j)
        except Exception as e:  # a call that fails counts its pairs failed
            failed += mix["requests_per_call"]
            ctx.log(f"call {j} failed: {type(e).__name__}: {e}")
            j += 1
            continue
        latencies.append(time.perf_counter() - t0)
        done.append((images, questions,
                     np.array([[index.get(a, -1) for a in
                                [r["answer"], *r["top_answers"][1:]]]
                               for r in results]),
                     np.array([r["top_probs"] for r in results])))
        j += 1
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    pairs = sum(len(d[0]) for d in done)
    host = {"seconds": dict(ctx.tracer.seconds),
            "calls": dict(ctx.tracer.calls)}
    ctx.log(f"window: {len(latencies)} calls, {pairs} pairs in "
            f"{window_s:.3f} s; latency median "
            f"{1e3 * float(np.median(latencies)) if latencies else 0:.2f} ms")

    profile = None
    if ctx.trace:
        n = mix["trace_calls"]
        ctx.tracer.reset()
        profile = ctx.profile(lambda: [call(10 ** 6 + i) for i in range(n)])
    stretch = {"forwards": ctx.tracer.calls.get("forward", 0),
               "chunks": ctx.tracer.calls.get("collate", 0)}

    ctx.thaw()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, answers, pool, bank, done, ctx.control)
    return {
        "mode": MODE, "attempted": attempted, "failed": failed,
        "metrics": {
            "serve_pairs_per_s": pairs / window_s,
            "serve_p95_ms": 1e3 * float(np.percentile(latencies, 95))
            if latencies else float("nan"),
            "peak_device_mib": peak / harness.MIB,
            "setup_s": setup_s},
        "checks": checks, "peak_bytes": peak, "profile": profile,
        "host": host, "stretch": stretch,
        "rate": pairs / window_s, "batch": mix["session_batch"],
        "counts": {"calls": len(latencies), "pairs": pairs,
                   "window_s": window_s}}


def sample(ctx, done, n: int):
    """``n`` answered pairs drawn from the seed: (image index, question
    index, served top-k answers, their served probabilities) arrays."""
    cols = [np.concatenate([d[k] for d in done]) for k in range(4)]
    r = harness.rng(ctx.seed, harness.CHECK)
    pick = np.sort(r.choice(len(cols[0]), size=min(n, len(cols[0])),
                            replace=False))
    return [c[pick] for c in cols]


def reference_logprobs(ctx, weights, answers, pool, bank, images,
                       questions, P: Precision):
    import torch

    block = ctx.mix["check_block"]
    out = []
    with torch.no_grad():
        for a in range(0, len(images), block):
            imgs = torch.from_numpy(pool[images[a:a + block]]).to(ctx.device)
            qs = [bank.texts[q] for q in questions[a:a + block]]
            out.append(ctx.part.serve_logprobs(
                weights, ctx.cfg, imgs, qs, answers, P).double().cpu())
    return torch.cat(out).numpy()


def numbers(ref: np.ndarray, answers: np.ndarray, probs: np.ndarray
            ) -> Dict[str, float]:
    """The compared numbers of served top-k ``answers`` [n, k] with their
    probabilities ``probs`` against the reference's log-probs ``ref``:
    ``top1_gap``, the widest gap by which a served answer lies below the
    reference's best of its pair; ``prob_err``, the widest difference
    between a served answer's probability and the reference's probability
    of the same answer; ``prob_rms``, the root mean square of that
    difference over every served answer of the sample."""
    if len(answers) == 0 or (answers < 0).any():
        return {"top1_gap": float("inf"), "prob_err": float("inf"),
                "prob_rms": float("inf")}
    rows = np.arange(len(answers))
    diff = probs - np.exp(np.take_along_axis(ref, answers, axis=1))
    return {"top1_gap": float((ref.max(1) - ref[rows, answers[:, 0]]).max()),
            "prob_err": float(np.abs(diff[:, 0]).max()),
            "prob_rms": float(np.sqrt(np.mean(np.square(diff))))}


def check(ctx, answers, pool, bank, done, control: bool = False
          ) -> Dict[str, Dict]:
    no_tf32()
    if not done:
        return {"top1_gap": {"value": float("inf"), "limit": None}}
    images, questions, served, probs = sample(ctx, done,
                                              ctx.mix["check_requests"])
    weights = harness.make_weights(ctx.model.reference.weight_spec(ctx.cfg),
                                   ctx.seed, ctx.device)
    ref = reference_logprobs(ctx, weights, answers, pool, bank, images,
                             questions, FP32)
    got = numbers(ref, served, probs)
    if control:
        low = reference_logprobs(ctx, weights, answers, pool, bank, images,
                                 questions, Precision("float8"))
        top = np.argsort(-low, axis=1)[:, :served.shape[1]]
        ctx.readings["control"] = numbers(
            ref, top, np.exp(np.take_along_axis(low, top, axis=1)))
    return ctx.judge(got)
