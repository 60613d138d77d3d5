"""``train_steps``: the program's training step as its trainer runs it.

Set-up builds one training step with ``setup_train_step`` (the optimizer,
clip and schedule of the configuration's ``train_config``) on the
benchmark's weights, and the port's input path: ``build_collates``, a
shuffled ``DataLoader`` and a ``Prefetcher`` copying batches to the
device, over the mix's samples and the run's images. It drives that step
from the seed through its first ``checked_steps`` steps (their losses,
the first gradient as the optimizer holds it, and the parameters before
and after are kept on the host) and ``warmup_steps`` more, then hands the
same step and feed to the window. The window runs steps for ``--seconds``
and reads the losses back in groups of ``loss_read_every``, as the trainer
reads them for its logs, each group once the next group's steps are
queued too: the device never drains for a read, and a stall of the host
shorter than the work queued costs the device nothing. When the time is
up no step is sent, the device finishes what was sent, and the window's
clock stops after that.

End-to-end: ``train_samples_per_s`` (the samples of every step of the
window over the window's seconds, which end when the device has finished
the last step), ``peak_device_mib``, ``setup_s``.

``correct``: once the window has closed and the program is freed, the
plain reference runs the checked steps from the same weights on the same
samples, each batch in passes of ``reference_rows`` rows so that it fits
beside nothing else on the card, with the dropout masks drawn from the
same generator state (and
its first step once more in float64, to tell which weights' gradients are
more than its own rounding), and two numbers are compared with their
limits (see ``numbers``).
"""

from __future__ import annotations

import collections
import gc
import re
import time
from typing import Dict, List

import numpy as np

from gpu_bench import faults, generate, harness
from gpu_bench.reference import inputs
from gpu_bench.reference.nn import FP32, Precision, no_tf32

MODE = "train"


def _feed(loader, num_prefetch: int, device):
    """The trainer's input path, epoch after epoch."""
    from t5_resnet_vqa_torch.data import Prefetcher

    while True:
        yield from Prefetcher(loader, num_prefetch, device)


def _rng_state(device):
    import torch

    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _seed_dropout(device, seed: int) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def _unread_failures(pending: List, n: int) -> int:
    """Read the oldest ``n`` losses of ``pending`` back, take them off it,
    and say whether any was not finite (1) or not (0)."""
    import torch

    if not n:
        return 0
    group = torch.stack(pending[:n]).sum()
    del pending[:n]
    return int(not np.isfinite(float(group)))


def run(ctx) -> Dict:
    import torch

    from t5_resnet_vqa_torch.core import Config
    from t5_resnet_vqa_torch.data import (
        Annotation,
        DataLoader,
        HashTokenizer,
        Question,
        Sample,
    )
    from t5_resnet_vqa_torch.train.trainer import (
        _device_batch,
        build_collates,
        prepare_model,
        setup_train_step,
    )

    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    dtype = getattr(torch, cfg["compute_dtype"])
    answers = harness.answer_space(cfg["answers"])
    weights = harness.make_weights(ctx.model.reference.weight_spec(cfg),
                                   seed, device)
    model = ctx.model.build(cfg, device, dropout=True)
    model.load_state_dict(weights, strict=True)
    del weights
    model = prepare_model(model, device, dtype).train()
    ctx.log("model built on the benchmark's weights")
    config = Config.from_dict(cfg["train_config"])
    total = mix["num_training_steps"]
    optimizer, _, _, step = setup_train_step(model, config, total,
                                             compute_dtype=dtype)
    collate = build_collates(
        config.dataset, answers, seed=harness.sub_seed(seed, harness.COLLATE),
        tokenizer=HashTokenizer(pinned_words=answers),
        family=ctx.model.FAMILY)[0]
    pool = generate.image_pool(mix["distinct_images"], cfg["image_size"],
                               seed, device)
    collate.load_images = lambda paths: pool[
        np.fromiter((int(p) for p in paths), np.int64)]
    bank = generate.QuestionBank(mix["questions"], seed)
    texts, images, answer_lists = generate.train_samples(mix, seed, answers,
                                                         bank)
    samples = [Sample(Question(t, f"q{i}", str(im)),
                      Annotation(f"q{i}", str(im), a), str(im))
               for i, (t, im, a) in enumerate(zip(texts, images,
                                                  answer_lists))]
    loader = DataLoader(samples, collate, mix["batch"], shuffle=True,
                        seed=harness.sub_seed(seed, harness.ORDER),
                        drop_remainder=True)
    feed = _feed(loader, mix["num_prefetch_batches"], device)
    ctx.log(f"{len(samples)} samples over {len(pool)} images")
    names = {p: n for n, p in model.named_parameters()}
    trainable = [p for g in optimizer.param_groups for p in g["params"]]
    faults.apply(ctx.fault, model=model, optimizer=optimizer)
    t = ctx.tracer
    t.hook_module(model, "forward")
    optimizer.register_step_pre_hook(lambda o, a, k: t.open("optimizer"))
    optimizer.register_step_post_hook(lambda o, a, k: t.close("optimizer"))

    def one_step():
        with t.span("input_wait"):
            raw = next(feed)
        with t.span("train_step"):
            return step(_device_batch(raw))[0]

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    _seed_dropout(device, harness.sub_seed(seed, harness.DROPOUT))
    rng_state = _rng_state(device)
    before = {names[p]: p.detach().to("cpu", copy=True) for p in trainable}
    losses, first_grad = [], {}
    beta1 = optimizer.param_groups[0]["betas"][0]
    for s in range(mix["checked_steps"]):
        losses.append(one_step())
        if s == 0:
            first_grad = {
                names[p]: (optimizer.state[p]["exp_avg"] / (1.0 - beta1)).cpu()
                if "exp_avg" in optimizer.state.get(p, {})
                else torch.zeros(p.shape) for p in trainable}
    after = {names[p]: p.detach().to("cpu", copy=True) for p in trainable}
    program = {"losses": [float(x) for x in losses],
               "first_grad": first_grad,
               "change": {k: after[k] - before[k] for k in before}}
    del before, after
    ctx.log(f"checked steps: losses {program['losses']}")
    for _ in range(mix["warmup_steps"]):
        one_step()
    ctx.settle()
    t.reset()
    setup_s = time.perf_counter() - ctx.t0

    every = mix["loss_read_every"]
    steps, failed, pending = 0, 0, []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        pending.append(one_step())
        steps += 1
        if len(pending) >= 2 * every:
            failed += _unread_failures(pending, every)
    ctx.sync()
    failed += _unread_failures(pending, len(pending))
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    host = {"seconds": dict(t.seconds), "calls": dict(t.calls)}
    ctx.log(f"window: {steps} steps in {window_s:.3f} s")

    profile = None
    if ctx.trace:
        n = mix["trace_steps"]
        t.reset()
        profile = ctx.profile(
            lambda: float(torch.stack([one_step() for _ in range(n)]).sum()))
    stretch = {"forwards": t.calls.get("forward", 0),
               "steps": t.calls.get("train_step", 0)}

    ctx.thaw()
    feed.close()
    del model, optimizer, step, feed, trainable, names
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    batches = reference_batches(ctx, answers, pool, texts, images,
                                answer_lists)
    checks = check(ctx, program, batches, rng_state, dtype, ctx.control)
    samples_per_s = steps * mix["batch"] / window_s
    return {
        "mode": MODE, "attempted": steps, "failed": failed,
        "metrics": {"train_samples_per_s": samples_per_s,
                    "peak_device_mib": peak / harness.MIB,
                    "setup_s": setup_s},
        "checks": checks, "peak_bytes": peak, "profile": profile,
        "host": host, "stretch": stretch, "rate": samples_per_s,
        "batch": mix["batch"],
        "counts": {"steps": steps, "window_s": window_s}}


def reference_batches(ctx, answers, pool, texts, images, answer_lists
                      ) -> List[Dict]:
    """The checked steps' batches as the reference works them out: the
    loader's order, the collate's answer draws, the question ids."""
    import torch

    B, n = ctx.mix["batch"], ctx.mix["checked_steps"]
    order = inputs.shuffled_order(len(texts), harness.sub_seed(
        ctx.seed, harness.ORDER))[:B * n]
    labels = inputs.drawn_labels([answer_lists[i] for i in order],
                                 harness.sub_seed(ctx.seed, harness.COLLATE),
                                 answers)
    ids, _ = inputs.question_ids([texts[i] for i in order],
                                 ctx.cfg["question_len"], answers)
    dev = ctx.device
    return [{"images": torch.from_numpy(pool[images[order[a:a + B]]]).to(dev),
             "ids": torch.from_numpy(ids[a:a + B]).to(dev),
             "labels": torch.from_numpy(labels[a:a + B]).to(dev)}
            for a in range(0, B * n, B)]


# A weight's first gradient counts where the float32 reference holds it to
# rounding: within this share of the float64 reference's. Only the weights
# whose gradient is zero but for rounding (each key's bias and the pooler's
# bias, under their softmax) fall outside; they read 1e8 and more.
ROUNDING = 1e-3
# A weight's change counts where its reference gradient reaches this share
# of the largest weight's. Below it, Adam's first steps at the warm-up's
# small rates fall under a float32 weight's resolution, and the float32
# reference's change departs from the float64 one's by 10% and more; above
# it by 4% at most (PERF.md).
CHANGE_FLOOR = 1e-6
_LAYER = re.compile(r"layers\.(\d+)\.")


def _norms(tensors: Dict) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def compared(ref: Dict, exact: Dict) -> Dict[str, List[str]]:
    """The weights each number compares (see ``numbers``)."""
    g_r = _norms(ref["first_grad"])
    floor = CHANGE_FLOOR * max(g_r.values())
    grad = [k for k, g in exact["first_grad"].items()
            if float((ref["first_grad"][k].double() - g.double()).norm())
            <= ROUNDING * float(g.double().norm())]
    return {"grad_err": grad,
            "change_gap": [k for k in grad if g_r[k] >= floor]}


def coverage(names: List[str]) -> str:
    """How many weights of each numbered layer (``...layers.<i>.``) a list
    holds; the weights outside them under ``other``."""
    per = collections.Counter(
        m.group(1) if (m := _LAYER.search(k)) else "other" for k in names)
    return ", ".join(f"{k}: {n}" for k, n in sorted(
        per.items(), key=lambda kv: (not kv[0].isdigit(),
                                     int(kv[0]) if kv[0].isdigit() else 0)))


def numbers(program: Dict, ref: Dict, keys: Dict[str, List[str]]
            ) -> Dict[str, float]:
    """``grad_err``: the worst weight's relative error of the first
    (clipped) gradient, the norm of the program's gradient less the
    reference's over the norm of the reference's, over every weight whose
    float32 reference gradient is more than rounding (``ROUNDING``): first
    order in the rounding that a lower precision adds, in every layer.
    ``change_gap``: the worst weight's gap between the norms of the change
    over the checked steps, relative to the reference's, over those of the
    weights whose reference gradient reaches ``CHANGE_FLOOR`` of the
    largest weight's: it holds the clip, AdamW and the schedule."""
    err = max(float((program["first_grad"][k].double()
                     - ref["first_grad"][k].double()).norm())
              / float(ref["first_grad"][k].double().norm())
              for k in keys["grad_err"])
    c_p, c_r = _norms(program["change"]), _norms(ref["change"])
    change = max(abs(c_p[k] - c_r[k]) / c_r[k] for k in keys["change_gap"])
    return {"change_gap": change, "grad_err": err}


def check(ctx, program, batches, rng_state, dtype, control: bool = False
          ) -> Dict[str, Dict]:
    no_tf32()
    weights = harness.make_weights(ctx.model.reference.weight_spec(ctx.cfg),
                                   ctx.seed, ctx.device)
    total = ctx.mix["num_training_steps"]

    def replay(P: Precision, steps: int):
        out = ctx.part.train_steps(weights, ctx.cfg, batches[:steps], total,
                                   P, rng_state, dtype,
                                   rows=ctx.mix["reference_rows"])
        return {"losses": out["losses"],
                "first_grad": {k: v.cpu() for k, v in
                               out["first_grad"].items()},
                "change": {k: v.cpu() for k, v in out["change"].items()}}

    ref = replay(FP32, len(batches))
    exact = replay(Precision("float64"), 1)
    keys = compared(ref, exact)
    ctx.log(f"reference losses {ref['losses']}")
    for k, names in keys.items():
        ctx.log(f"{k} compares {len(names)} of {len(ref['first_grad'])} "
                f"weights; by layer {coverage(names)}")
    got = numbers(program, ref, keys)
    low = replay(Precision("float8"), len(batches)) if control else None
    if control:
        ctx.readings["control"] = numbers(low, ref, keys)
    if ctx.rounding:
        ctx.readings["leaves"] = leaf_rows(
            program, ref, replay(Precision("float64"), len(batches)), low)
    return ctx.judge(got)


def leaf_rows(program: Dict, ref: Dict, ref64: Dict, low=None) -> List:
    """Per trainable weight: the norms of its first gradient and of its
    change in the float64 reference and the float32 one; the float32
    reference's relative error of the first gradient and gap of the
    change's norm against float64; the program's, and the control's, against
    the float32 reference. ``calibrate.py --rounding`` prints them: the
    float32 reference's own rounding beside the program's."""
    def err(a, b):
        nb = float(b.double().norm())
        return float((a.double() - b.double()).norm()) / nb if nb else None

    def gap(a, b):
        na, nb = float(a.double().norm()), float(b.double().norm())
        return abs(na - nb) / nb if nb else (None if na == 0 else 1.0)

    rows = []
    for k, g in ref64["first_grad"].items():
        g32, c, c32 = ref["first_grad"][k], ref64["change"][k], \
            ref["change"][k]
        row = {"leaf": k, "grad": float(g.norm()), "change": float(c.norm()),
               "grad32": float(g32.double().norm()),
               "change32": float(c32.double().norm()),
               "grad_err32": err(g32, g), "change_gap32": gap(c32, c),
               "grad_errp": err(program["first_grad"][k], g32),
               "change_gapp": gap(program["change"][k], c32)}
        if low is not None:
            row["grad_err8"] = err(low["first_grad"][k], g32)
            row["change_gap8"] = gap(low["change"][k], c32)
        rows.append(row)
    return rows
