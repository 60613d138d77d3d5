"""``serve_generate``: closed-loop clients of the program's generating
session (``VQAInferenceSession.generate_batch``), one call after another.

A pair's shape (``image_height``, ``image_width``, ``answer_tokens``) is
the configuration's, under any that the mix's ``shape`` gives: the loop
lays that over the configuration for the run, so that the counts and the
reference read the cell's shape, and a cell of another shape needs only
its traffic file.

Set-up draws the weights on the device, one sub-seed a tensor, in the
configuration's compute dtype (``model.program_weights``: 16.4 B
parameters would not fit as one float32 buffer beside them), builds the
session on them (the model built on ``meta`` takes them as they are),
hands its collate the run's images (seeded uint8 arrays at the
configuration's size, padded by the collate) and warms up with calls of
the window's shape. The window then makes calls for ``--seconds``: each
carries the mix's ``requests_per_call`` pairs (chunks of
``session_batch``), greedy, ``answer_tokens`` tokens a pair, and is timed
on the host clock around the call, which returns every answer.

End-to-end: ``serve_pairs_per_s``, ``serve_p95_ms``, ``peak_device_mib``,
``setup_s``, as ``serve_closed`` reads them.

The traced run also keeps the program's counters over the profiled
stretch (``stretch_counters``: what ``moe_op_roofline.generate`` reads).

``correct``: once the window has closed, one answered call drawn from the
seed is made again with the program's expert choices recorded
(``ops.moe.recorded_routes``), and the program is freed. A sample of that
call's pairs then goes through the plain reference in float32 in blocks
(each block drawing the weights again, a layer at a time): the full
forward over the prompt and the served tokens, read at every step, each
sparse layer taking the experts the program took. Under random weights
many experts' scores nearly tie, bf16 and float32 choose differently
among them, and each changed choice moves a row by a whole expert's share
in every later layer; taking the program's choices, and reading how far
each lies from the reference's own (``route_gap``), keeps the comparison
to the arithmetic. The numbers read (``numbers``): ``gen_top1_gap``,
``prefill_lp_rms``, ``decode_lp_rms``, ``route_gap``, and
``rerun_mismatch`` (sampled pairs whose tokens or top ids the call made
again did not repeat); those that the cell's limits name are compared.
The control is the reference in float8, choosing its own experts, in the
program's place.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Sequence

import numpy as np

from gpu_bench import generate, harness, program_trace
from gpu_bench.reference.nn import FP32, Precision, no_tf32

MODE = "generate"


def _session(ctx, model, weights):
    import torch

    from t5_resnet_vqa_torch.data import HashTokenizer
    from t5_resnet_vqa_torch.eval.session import VQAInferenceSession

    cfg, mix = ctx.cfg, ctx.mix
    return VQAInferenceSession(
        model, weights, [],
        family=ctx.model.FAMILY, batch_size=mix["session_batch"],
        image_size=(cfg["image_height"], cfg["image_width"]),
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        device=ctx.device,
        tokenizer=HashTokenizer(vocab_size=cfg["vocab_size"]))


def image_pool(n: int, height: int, width: int, seed: int, device
               ) -> np.ndarray:
    """[n, height, width, 3] uint8, drawn on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, harness.IMAGES))
    images = torch.randint(0, 256, (n, height, width, 3), dtype=torch.uint8,
                           generator=gen, device=device)
    return images.cpu().numpy()


def _instrument(ctx, session) -> None:
    t = ctx.tracer
    for attr, name in (("_collate_prompts", "collate"),
                       ("_to_device", "copy"),
                       ("generate_batch", "generate_batch")):
        t.wrap(session, attr, name)


def _counter_delta(before, after) -> Dict[str, int]:
    if before is None or after is None:
        return {}
    return {k: v - before.get(k, 0) for k, v in after.items()}


def run(ctx) -> Dict:
    import torch

    ctx.cfg = {**ctx.cfg, **ctx.mix.get("shape", {})}
    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    model = ctx.model.build(cfg, device)    # before any weight is drawn
    weights = ctx.model.program_weights(cfg, seed, device)
    session = _session(ctx, model, weights)
    del model, weights
    ctx.log("session built on the benchmark's weights")
    pool = image_pool(mix["image_pool"], cfg["image_height"],
                      cfg["image_width"], seed, device)
    session.collate.load_images = lambda paths: pool[
        np.fromiter((int(p) for p in paths), np.int64)]
    bank = generate.QuestionBank(mix["questions"], seed)
    _instrument(ctx, session)
    n_tokens = cfg["answer_tokens"]

    def call(j):
        images, questions = generate.serve_call(mix, seed, j, len(pool), bank)
        reqs = [(str(i), bank.texts[q]) for i, q in zip(images, questions)]
        return images, questions, session.generate_batch(
            reqs, max_answer_length=n_tokens)

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
            images, questions, records = call(j)
        except Exception as e:  # a call that fails counts its pairs failed
            failed += mix["requests_per_call"]
            ctx.log(f"call {j} failed: {type(e).__name__}: {e}")
            j += 1
            continue
        latencies.append(time.perf_counter() - t0)
        done.append((images, questions, records, j))
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

    profile, counts = None, {}
    if ctx.trace:
        n = mix["trace_calls"]
        ctx.tracer.reset()
        before = program_trace.counters()
        profile = ctx.profile(lambda: [call(10 ** 6 + i) for i in range(n)])
        counts = _counter_delta(before, program_trace.counters())
    stretch = {"forwards": ctx.tracer.calls.get("generate_batch", 0),
               "chunks": ctx.tracer.calls.get("collate", 0)}

    picked = pick(ctx, done, bank, lambda j: call(j)[2]) if done else None
    ctx.thaw()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, pool, bank, done, picked, ctx.control)
    return {
        "mode": MODE, "attempted": attempted, "failed": failed,
        "metrics": {
            "serve_pairs_per_s": pairs / window_s,
            "serve_p95_ms": 1e3 * float(np.percentile(latencies, 95))
            if latencies else float("nan"),
            "peak_device_mib": peak / harness.MIB,
            "setup_s": setup_s},
        "checks": checks, "peak_bytes": peak, "profile": profile,
        "host": host, "stretch": stretch, "stretch_counters": counts,
        "rate": pairs / window_s, "batch": mix["session_batch"],
        "counts": {"calls": len(latencies), "pairs": pairs,
                   "window_s": window_s}}


def pick(ctx, done, bank, call):
    """The checked pairs: an answered call drawn from the seed and the mix's
    ``check_requests`` of its pairs, with the experts the program takes for
    each: the call is made again (``call(j)`` -> its records) with the
    program's choices recorded, and each pair's cut to the positions the
    reference runs (the prompt, then the served tokens but the last), a
    [positions, k] tensor for each sparse layer. -> (index into ``done``,
    the pairs' rows, their routes, how many of them the call made again
    answered otherwise)."""
    import torch

    from t5_resnet_vqa_torch.ops.moe import recorded_routes

    cfg, B = ctx.cfg, ctx.mix["session_batch"]
    r = harness.rng(ctx.seed, harness.CHECK)
    c = int(r.integers(len(done)))
    _, questions, served, j = done[c]
    rows = np.sort(r.choice(len(served), replace=False,
                            size=min(ctx.mix["check_requests"],
                                     len(served))))
    with recorded_routes() as recorded:
        again = call(j)
    recorded = [t.cpu() for t in recorded]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    per_chunk = layers * cfg["answer_tokens"]   # the prefill, each step
    image_tokens = ctx.part.image_tokens(cfg)
    routes, mismatch = [], 0
    for b in rows:
        chunk = recorded[b // B * per_chunk:(b // B + 1) * per_chunk]
        row = b % B
        prompt = len(ctx.model.reference.prompt_ids(
            cfg, bank.texts[questions[b]], image_tokens))
        steps = len(served[b]["token_ids"]) - 1
        routes.append([torch.cat(
            [chunk[l].view(B, -1, chunk[l].shape[-1])[row, :prompt]]
            + [chunk[s * layers + l][row:row + 1]
               for s in range(1, 1 + steps)])
            for l in range(layers)])
        mismatch += (again[b]["token_ids"] != served[b]["token_ids"]
                     or again[b]["token_logprobs"]["ids"]
                     != served[b]["token_logprobs"]["ids"])
    return c, rows, routes, mismatch


def reference_logprobs(ctx, pool, bank, images, questions,
                       tokens: Sequence[Sequence[int]], P: Precision,
                       routes=None):
    """Each pair's reference log-probs [steps, vocab] over its prompt and
    ``tokens``, the experts it took (``routes``, where given) and its
    widest route gap, in blocks of the mix's ``check_block`` pairs."""
    import torch

    block = ctx.mix["check_block"]
    out, taken, gaps = [], [], []
    with torch.no_grad():
        for a in range(0, len(images), block):
            W = ctx.model.LazyWeights(ctx.cfg, ctx.seed, ctx.device)
            imgs = torch.from_numpy(pool[images[a:a + block]]).to(ctx.device)
            qs = [bank.texts[q] for q in questions[a:a + block]]
            lps, tops, gs = ctx.part.generate_logprobs(
                W, ctx.cfg, imgs, qs, tokens[a:a + block], P,
                None if routes is None else routes[a:a + block])
            out += [lp.double().cpu().numpy() for lp in lps]
            taken += [[t.cpu() for t in top] for top in tops]
            gaps += gs
    return out, taken, gaps


def numbers(ref: Sequence[np.ndarray], ids: Sequence[np.ndarray],
            values: Sequence[np.ndarray], gaps: Sequence[float]
            ) -> Dict[str, float]:
    """The compared numbers of top-k ``ids`` [steps, k] with their
    log-probs ``values`` (a chosen token's first) against the reference's
    log-probs ``ref`` [steps, vocab], pair by pair: ``gen_top1_gap``, the
    widest gap by which the reference's log-prob of a chosen token lies
    below its best at that step; ``prefill_lp_rms``, the root mean square
    of the differences between the given and the reference's log-probs of
    the top-k at step 1; ``decode_lp_rms``, the same over the later
    steps; ``route_gap``, the widest of the pairs' route ``gaps``."""
    if not ref:
        return {"gen_top1_gap": float("inf"), "prefill_lp_rms": float("inf"),
                "decode_lp_rms": float("inf"), "route_gap": float("inf")}
    gap, first, later = 0.0, [], []
    for lp, i, v in zip(ref, ids, values):
        steps = np.arange(len(i))
        gap = max(gap, float((lp.max(1) - lp[steps, i[:, 0]]).max()))
        diff = v - np.take_along_axis(lp, i, axis=1)
        first.append(diff[0])
        later.extend(diff[1:])
    rms = lambda d: float(np.sqrt(np.mean(np.square(d)))) if d else 0.0
    return {"gen_top1_gap": gap, "prefill_lp_rms": rms(first),
            "decode_lp_rms": rms(later), "route_gap": float(max(gaps))}


def check(ctx, pool, bank, done, picked, control: bool = False
          ) -> Dict[str, Dict]:
    no_tf32()
    if not done:
        return {"gen_top1_gap": {"value": float("inf"), "limit": None}}
    c, rows, routes, mismatch = picked
    images, questions, served, _ = done[c]
    images, questions = images[rows], questions[rows]
    records = [served[i] for i in rows]
    tokens = [r["token_ids"] for r in records]
    ids = [np.asarray(r["token_logprobs"]["ids"]) for r in records]
    values = [np.asarray(r["token_logprobs"]["values"]) for r in records]
    ref, _, gaps = reference_logprobs(ctx, pool, bank, images, questions,
                                      tokens, FP32, routes)
    got = dict(numbers(ref, ids, values, gaps), rerun_mismatch=mismatch)
    if control:
        k = ids[0].shape[1]
        low, low_routes, _ = reference_logprobs(
            ctx, pool, bank, images, questions, tokens, Precision("float8"))
        ref, _, gaps = reference_logprobs(ctx, pool, bank, images, questions,
                                          tokens, FP32, low_routes)
        top = [np.argsort(-lp, axis=1)[:, :k] for lp in low]
        ctx.readings["control"] = numbers(
            ref, top, [np.take_along_axis(lp, t, axis=1)
                       for lp, t in zip(low, top)], gaps)
    return ctx.judge(got)
