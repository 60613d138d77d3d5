#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. build   -- compile every kernel of ``t5_resnet_vqa_torch/csrc`` with nvcc
              (one process per source, in parallel) into the package's
              ``_build/`` directory; require compute capability 9.0.
2. kernels -- hold each hand-written kernel against its plain PyTorch
              version on the card, at the shapes the main path gives it
              (and attention at the ViT geometry), in fp32 and bf16, and
              time kernel, plain version and (for attention) PyTorch's
              ``scaled_dot_product_attention`` (for the bottleneck, the
              unfused modules) as device time from the profiler.
3. serve   -- the port's main path at full width: ResNet-50 + T5-base
              (12 layers, d_model 768) + 3 SGA blocks (H=8, D=96), 170
              answers, bf16, random weights from a seeded generator, behind
              ``VQAInferenceSession.ask_batch`` at batch 64: 192 requests,
              three forwards. Seeded uint8 images stand in for the image
              files (the card's machine has no decoder). Checks the launch
              counts (6 attention and 7 bottleneck launches per forward),
              the answers, finite log-probs whose rows sum to one and give
              the served top-k, and agreement with the same weights run
              with the kernels off (bf16, and once in fp32). Then times
              ``ask_batch`` with the kernels on and off in turns, ROUNDS
              times each (medians and fastest in the serve line), and
              times back-to-back forwards of each with CUDA events (pairs/s
              of the forward alone) and profiles one forward of each
              (device time and kernel launches of the vision tower, the
              text tower and the forward, and the device's idle share).

Prints one JSON line per phase, then the card's name and power limit as
nvidia-smi reports them, then the kernels line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.

In the kernels line, ``launches`` is the count over the three served
forwards; ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are per
forward: the bf16 times of the kernel phase summed over the shapes one
forward launches (attention: 5 at Sk=16 and 1 at Sk=64; bottleneck: the
seven blocks of stages 0 and 1); ``max_abs_err`` is the largest of those
cases. Bounds are the larger of bytes over 3.35 TB/s and FLOPs over the
dtype's peak (989 TFLOP/s bf16, 67 TFLOP/s fp32), H100 SXM data sheet.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor cores
              "float32": 67e12}       # CUDA cores (the fp32 path uses no TF32)
ATT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGPROB_TOL = {"float32": 1e-3, "bfloat16": 5e-2}

BATCH = 64
CHUNKS = 3
ROUNDS = 20            # timed ask_batch rounds per configuration
ANSWERS = 170          # the DAQUAR answer-space size
IMAGE = 256


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: its kernels' time from
    the profiler over ``iters`` calls. CUDA events around a loop would time
    the host's launches instead, which take longer than a small kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return profile_device(torch, fn, iters)["busy_ms"]


def bound_terms(nbytes: float, flops: float, dtype: str):
    """(ms to move the bytes at the memory rate, ms for the operations at
    the dtype's peak); the bound is the larger."""
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS[dtype] * 1e3)


def bound_by(t_bytes: float, t_ops: float) -> str:
    return "bytes" if t_bytes >= t_ops else "operations"


def add_bound(per_forward: dict, n: int, t_bytes: float, t_ops: float):
    """Add ``n`` launches' bound to a per-forward sum. The sum's label comes
    from its summed byte and operation terms, not from any one shape."""
    per_forward["bound_ms"] += n * max(t_bytes, t_ops)
    per_forward["bytes_ms"] += n * t_bytes
    per_forward["ops_ms"] += n * t_ops
    per_forward["bound_by"] = bound_by(per_forward["bytes_ms"],
                                       per_forward["ops_ms"])


def rel_err(got, want) -> tuple:
    got, want = got.detach().float(), want.detach().float()
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


# ------------------------------------------------------------------ phases

def phase_build(torch, card):
    from t5_resnet_vqa_torch.ops import kernel_build

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card "
                           f"has compute capability {cap}")
    t0 = time.perf_counter()
    kernel_build.build(["attention", "bottleneck"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "device": torch.cuda.get_device_name(0), "card": card,
          "capability": list(cap), "build_dir": kernel_build.BUILD_DIR})


ATTENTION_CASES = [       # name, B, H, Sq, Sk, D, launches per forward
    ("sga_sk16", BATCH, 8, 16, 16, 96, 5),
    ("sga_sk64", BATCH, 8, 16, 64, 96, 1),
    ("vit_s197", BATCH, 12, 197, 197, 64, 0),
]


def phase_attention(torch):
    import torch.nn.functional as F
    from t5_resnet_vqa_torch.ops import attention as A

    per_forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0,
                   "library_ms": 0.0, "max_abs_err": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, B, H, Sq, Sk, D, n_fwd in ATTENTION_CASES:
            g = torch.Generator(device="cuda").manual_seed(1)
            q = torch.randn(B, H, Sq, D, device="cuda", generator=g).to(dtype)
            k = torch.randn(B, H, Sk, D, device="cuda", generator=g).to(dtype)
            v = torch.randn(B, H, Sk, D, device="cuda", generator=g).to(dtype)
            got = A.fused_attention(q, k, v)
            want = A.attention_reference(q, k, v)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            if not rel <= ATT_TOL[dtype_name]:
                raise AssertionError(
                    f"attention {name} {dtype_name}: max-abs error "
                    f"{abs_err} ({rel} of max|ref|) > {ATT_TOL[dtype_name]}")
            ms = device_ms(torch, lambda: A.fused_attention(q, k, v))
            plain_ms = device_ms(torch,
                                 lambda: A.attention_reference(q, k, v))
            lib_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            t_bytes, t_ops = bound_terms(nbytes, 4.0 * B * H * Sq * Sk * D,
                                         dtype_name)
            emit({"phase": "kernel", "kernel": "attention", "case": name,
                  "dtype": dtype_name, "shape": [B, H, Sq, Sk, D],
                  "max_abs_err": abs_err, "rel_err": rel,
                  "tol": ATT_TOL[dtype_name], "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                  "bound_by": bound_by(t_bytes, t_ops)})
            if dtype_name == "bfloat16" and n_fwd:
                per_forward["ms"] += n_fwd * ms
                per_forward["plain_ms"] += n_fwd * plain_ms
                per_forward["library_ms"] += n_fwd * lib_ms
                add_bound(per_forward, n_fwd, t_bytes, t_ops)
                per_forward["max_abs_err"] = max(per_forward["max_abs_err"],
                                                 abs_err)
    return per_forward


BLOCK_CASES = [    # name, H, Cin, width, stride, downsample, launches/forward
    ("stage0_block0", 64, 64, 64, 1, True, 1),
    ("stage0_block1", 64, 256, 64, 1, False, 2),
    ("stage1_block0", 64, 256, 128, 2, True, 1),
    ("stage1_block1", 32, 512, 128, 1, False, 3),
]


def phase_bottleneck(torch):
    from t5_resnet_vqa_torch.models.resnet import Bottleneck
    from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
    from t5_resnet_vqa_torch.ops import bottleneck as K

    per_forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0,
                   "library_ms": None, "max_abs_err": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, H, cin, width, stride, ds, n_fwd in BLOCK_CASES:
            block = Bottleneck(cin, width, stride, ds)
            init_weights(block, torch.Generator().manual_seed(2))
            block = block.to("cuda", dtype).eval()
            g = torch.Generator(device="cuda").manual_seed(3)
            x = torch.randn(BATCH, H, H, cin, device="cuda",
                            generator=g).to(dtype)
            ops = block.fused_operands(dtype)
            got = K.fused_bottleneck(x, *ops, stride=stride)
            want = K.bottleneck_reference(x, *ops, stride=stride)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            if not rel <= BLOCK_TOL[dtype_name]:
                raise AssertionError(
                    f"bottleneck {name} {dtype_name}: max-abs error "
                    f"{abs_err} ({rel} of max|ref|) > {BLOCK_TOL[dtype_name]}")
            ms = device_ms(torch, lambda: K.fused_bottleneck(x, *ops,
                                                             stride=stride))
            plain_ms = device_ms(torch, lambda: K.bottleneck_reference(
                x, *ops, stride=stride), iters=5)
            x_nchw = x.permute(0, 3, 1, 2)
            with torch.inference_mode():
                module_ms = device_ms(torch, lambda: block(x_nchw))
            Ho = H // stride
            cw, cout = width, 4 * width
            flops = 2.0 * BATCH * (H * H * cin * cw + Ho * Ho * 9 * cw * cw
                                   + Ho * Ho * cw * cout
                                   + (Ho * Ho * cin * cout if ds else 0))
            nbytes = (x.numel() + BATCH * Ho * Ho * cout) * x.element_size() \
                + sum(t.numel() * t.element_size() for t in ops
                      if t is not None)
            t_bytes, t_ops = bound_terms(nbytes, flops, dtype_name)
            emit({"phase": "kernel", "kernel": "bottleneck", "case": name,
                  "dtype": dtype_name,
                  "shape": [BATCH, H, H, cin, width, stride, int(ds)],
                  "max_abs_err": abs_err, "rel_err": rel,
                  "tol": BLOCK_TOL[dtype_name], "ms": ms,
                  "plain_ms": plain_ms, "unfused_module_ms": module_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": bound_by(t_bytes, t_ops)})
            if dtype_name == "bfloat16":
                per_forward["ms"] += n_fwd * ms
                per_forward["plain_ms"] += n_fwd * plain_ms
                add_bound(per_forward, n_fwd, t_bytes, t_ops)
                per_forward["max_abs_err"] = max(per_forward["max_abs_err"],
                                                 abs_err)
    return per_forward


def _build_model(torch, dtype, use_kernels):
    from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
    from t5_resnet_vqa_torch.ops import AttentionConfig

    return ResnetVQAModel(
        ANSWERS, vision_model_name="resnet50", t5_config=T5Config.t5_base(),
        num_attention_blocks=3, sga_config=AttentionConfig(),
        use_kernels=use_kernels, dtype=dtype, device="cuda",
        generator=torch.Generator().manual_seed(0))


def phase_serve(torch, card):
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K

    answers = [f"answer{i:03d}" for i in range(ANSWERS)]
    rng = np.random.default_rng(0)
    objects = ["table", "chair", "lamp", "sofa", "bottle", "book", "cup"]
    requests = [(f"request_{i}.png",
                 f"what is on the {objects[int(rng.integers(len(objects)))]}"
                 f" number {i % BATCH}") for i in range(CHUNKS * BATCH)]
    images = {path: rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
              for path, _ in requests}

    def load_images(paths):
        # the card's machine has no image decoder: seeded uint8 images
        # stand in for the files (the CPU tests cover decoding)
        return np.stack([images[p] for p in paths])

    def serving(use_kernels, state=None):
        model = _build_model(torch, torch.bfloat16, use_kernels)
        session = VQAInferenceSession(model, state, answers, "cnn",
                                      batch_size=BATCH, device="cuda")
        session.collate.load_images = load_images
        return session

    session = serving(use_kernels=True)
    session.ask_batch(requests[:BATCH])       # first call: allocator, cuDNN
    torch.cuda.synchronize()

    # the main path once: three chunks of requests, counts read right after
    A.launches = 0
    K.launches = 0
    first_ms, results = serve_ms(torch, session, requests)
    launches = {"attention": A.launches, "bottleneck": K.launches}
    if launches != {"attention": 6 * CHUNKS, "bottleneck": 7 * CHUNKS}:
        raise AssertionError(f"launch counts {launches}, expected 6 and 7 "
                             f"per forward over {CHUNKS} forwards")
    if len(results) != len(requests) or \
            not all(r["answer"] in answers for r in results):
        raise AssertionError("answers missing or outside the answer space")

    # the log-probs behind those answers, and the same weights with the
    # kernels off (bf16): the same collated batches through both models
    plain = serving(use_kernels=False, state=session.model.state_dict())
    batches = [session._to_device(session._collate_chunk(
        requests[c * BATCH:(c + 1) * BATCH])) for c in range(CHUNKS)]
    bf16_diff = 0.0
    for c, batch in enumerate(batches):
        lp = session._predict(batch).cpu().numpy()
        if lp.shape != (BATCH, ANSWERS) or not np.isfinite(lp).all():
            raise AssertionError(f"log-probs of shape {lp.shape}, "
                                 f"finite={np.isfinite(lp).all()}")
        sums = np.exp(lp.astype(np.float64)).sum(-1)
        if not np.abs(sums - 1.0).max() <= 1e-3:
            raise AssertionError(f"probabilities sum to {sums.min()}.."
                                 f"{sums.max()}")
        served = np.array([r["top_probs"]
                           for r in results[c * BATCH:(c + 1) * BATCH]])
        top = np.exp(np.sort(lp, axis=-1)[:, ::-1][:, :3])
        # the same inputs through the same model; 1e-4 leaves room for a
        # library that sums in another order from one call to the next
        if not np.abs(served - top).max() <= 1e-4:
            raise AssertionError("served top-k probabilities differ from the "
                                 "forward's log-probs")
        off = plain._predict(batch).cpu().numpy()
        bf16_diff = max(bf16_diff, float(np.abs(lp - off).max()))
    if not bf16_diff <= LOGPROB_TOL["bfloat16"]:
        raise AssertionError(f"bf16 kernels on/off log-probs differ by "
                             f"{bf16_diff} > {LOGPROB_TOL['bfloat16']}")

    # kernels on and off in turns (on, off, off, on, ...): serving is partly
    # bound by the host, whose speed drifts within a run
    rounds = {"kernels_on": [], "kernels_off": []}
    for r in range(ROUNDS):
        order = ("kernels_on", "kernels_off") if r % 2 == 0 else \
            ("kernels_off", "kernels_on")
        for label in order:
            s = session if label == "kernels_on" else plain
            rounds[label].append(serve_ms(torch, s, requests)[0])
    for label, s in (("kernels_on", session), ("kernels_off", plain)):
        phase_breakdown(torch, label, s.model, batches[0], card)

    # and once in fp32 (no TF32 anywhere), on one chunk
    state = session.model.state_dict()
    del session, plain
    torch.cuda.empty_cache()
    fp32 = {}
    for flag in (True, False):
        m = _build_model(torch, torch.float32, use_kernels=flag)
        m.load_state_dict(state, strict=True)
        with torch.inference_mode():
            fp32[flag] = m.eval()(**batches[0])[0]
        del m
    fp32_diff = float((fp32[True] - fp32[False]).abs().max())
    if not fp32_diff <= LOGPROB_TOL["float32"]:
        raise AssertionError(f"fp32 kernels on/off log-probs differ by "
                             f"{fp32_diff} > {LOGPROB_TOL['float32']}")

    pairs = len(requests)
    median = {label: float(np.median(ms)) for label, ms in rounds.items()}
    emit({"phase": "serve", "card": card,
          "model": "resnet50 + t5-base + 3xSGA", "answers": ANSWERS,
          "dtype": "bfloat16", "batch": BATCH, "requests": pairs, "launches": launches,
          "first_run_ms": first_ms,
          "ask_batch_ms": median["kernels_on"],
          "pairs_per_s": pairs / (median["kernels_on"] / 1e3),
          "kernels_off_ask_batch_ms": median["kernels_off"],
          "kernels_off_pairs_per_s": pairs / (median["kernels_off"] / 1e3),
          "fastest_ask_batch_ms": {label: float(min(ms))
                                   for label, ms in rounds.items()},
          "rounds_ms": rounds,
          "logprob_diff_bf16": bf16_diff, "logprob_diff_fp32": fp32_diff,
          "sample_answer": results[0]})
    return launches


def serve_ms(torch, session, requests):
    """(milliseconds on the host clock of one ``ask_batch`` over
    ``requests``, which reads every answer back, and its answers)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = session.ask_batch(requests, top_k=3)
    return (time.perf_counter() - t0) * 1e3, results


def phase_breakdown(torch, label, model, batch, card):
    """Where one bf16 forward's time goes. CUDA-event times of the vision
    tower, the text tower and the whole forward (the rest is the
    projection, SGA and head), and the pairs/s of back-to-back forwards
    that the last gives; from the profiler, for each of the three,
    the device time of its kernels (kernel rows only: an operator row
    repeats its kernels' time) and how many it launched; the device's idle
    share over back-to-back forwards, with its busy time and its elapsed
    time both taken in one profiled window (the profiler's own host work
    is in that window); the forward's busiest kernels."""
    with torch.inference_mode():
        parts = {
            "vision": lambda: model.compute_vision_features(
                batch["image_tensors"]),
            "text": lambda: model.lang_model(
                batch["question_input_ids"],
                batch["question_attention_masks"]),
            "forward": lambda: model(**batch),
        }
        wall = {name: cuda_ms(torch, fn, iters=10)
                for name, fn in parts.items()}
        device = {name: profile_device(torch, fn, iters=1)
                  for name, fn in parts.items()}
        window = profile_device(torch, parts["forward"], iters=10)
    emit({"phase": "breakdown", "config": label, "card": card,
          "batch": BATCH, "dtype": "bfloat16",
          "forward_pairs_per_s": BATCH / (wall["forward"] / 1e3),
          "vision_ms": wall["vision"],
          "text_ms": wall["text"], "forward_ms": wall["forward"],
          "rest_ms": wall["forward"] - wall["vision"] - wall["text"],
          "device_busy_ms": {k: v["busy_ms"] for k, v in device.items()},
          "kernel_launches": {k: v["launches"] for k, v in device.items()},
          "device_idle_share": 1.0 - window["busy_ms"] / window["elapsed_ms"],
          "idle_window": {"forwards": 10, "busy_ms": window["busy_ms"],
                          "elapsed_ms": window["elapsed_ms"]},
          "top_kernels": [{"us": us, "calls": n, "name": name}
                          for us, n, name in device["forward"]["kernels"][:12]]})


def profile_device(torch, fn, iters: int = 1) -> dict:
    """``iters`` back-to-back calls of ``fn`` under the profiler. Per call:
    ``busy_ms`` (the device time of the profiler's kernel rows),
    ``launches`` and ``elapsed_ms`` (CUDA events around the calls, in the
    same window); and ``kernels``, [(us, calls, name)] busiest first over
    the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.count, e.key[:90])
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"busy_ms": busy_ms / iters,
            "launches": sum(k[1] for k in kernels) / iters,
            "elapsed_ms": start.elapsed_time(end) / iters,
            "kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU "
              "port and has nothing to run here", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_build(torch, card)
    att = phase_attention(torch)
    blk = phase_bottleneck(torch)
    launches = phase_serve(torch, card)

    print(card, flush=True)

    kernels = []
    for name, numbers, source, replaces in (
            ("attention", att, "t5_resnet_vqa_torch/csrc/attention.cu",
             "t5_resnet_vqa_tpu/ops/pallas/attention.py:56"),
            ("bottleneck", blk, "t5_resnet_vqa_torch/csrc/bottleneck.cu",
             "t5_resnet_vqa_tpu/ops/pallas/bottleneck.py:84")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": numbers["max_abs_err"],
                        "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                        "bound_ms": numbers["bound_ms"],
                        "bound_by": numbers["bound_by"],
                        "library_ms": numbers["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
