#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. build   -- compile every kernel of ``t5_resnet_vqa_torch/csrc`` with nvcc
              (one process per source, in parallel) into the package's
              ``_build/`` directory; require compute capability 9.0.
2. kernels -- hold each hand-written kernel against its plain PyTorch
              version on the card, at the shapes the main path gives it
              (and attention at the ViT geometry, S=197, and the RoBERTa
              geometry of the cross-attention family, S=213), in fp32 and
              bf16, and
              time kernel, plain version and (for attention) PyTorch's
              ``scaled_dot_product_attention`` (for the bottleneck, the
              unfused modules) as device time from the profiler. Attention
              is also checked and timed on the head views of [B, S, H*D]
              projections, as the main path hands them over
              (``ms_head_views``); the bottleneck takes the operands its
              module packed once (``Bottleneck.fused``), as on the main
              path, and its line gives the weight bytes the design streams
              from L2 per launch (``weight_stream_mb``, from the shapes).
              The attention kernel's backward (the VJP of the plain
              version) is held against autograd of the plain version on
              head views, and timed (``bwd_ms``), at the SGA shapes, the
              ViT shape (``vit_bwd_ms``) and the RoBERTa shape
              (``cross_bwd_ms``).
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
4. serve_vit -- the ViT family's serving path at full width: ViT-base
              (12 layers, 224^2 images in 16x16 patches, 197 tokens) +
              T5-base encoder and decoder (12 + 12 layers, one tied
              32128-row table), 170 answers, bf16, random weights from a
              seeded generator, seeded uint8 images. ``ask_batch`` over 192
              requests (three forwards of 64): 12 attention launches per
              forward (the ViT self-attention at S=197), finite log-probs
              whose rows sum to one and give the served top-k, kernels on
              against off (bf16 and fp32). ``generate_batch`` on one chunk,
              greedy and beam (3 beams, 5 tokens): kernels on against off in
              fp32 (tokens equal, beam scores within 1e-4); in bf16 the
              share of equal greedy tokens is printed. Then ``ask_batch``
              and ``generate_batch`` times with the kernels on and off in
              turns, VIT_ROUNDS times each, and a profile of one forward of
              each (device time and launches of the tower, the T5 encoder,
              the decoder and the forward; idle share) and of one greedy
              and one beam ``generate_batch`` of each (device time,
              launches, idle share).
5. serve_frcnn, serve_cross -- the Faster-RCNN family (ResNet-50 body +
              FPN, whose 4x4 ``pool`` level gives 16 vision tokens, +
              T5-base + 3 SGA blocks, 256^2 images) and the cross-attention
              family (ViT-base x RoBERTa-base, 12 interleaved layers, 224^2
              images, 197 + 16 tokens in the RoBERTa layers) at full width,
              170 answers, bf16, seeded weights and images, behind
              ``ask_batch`` over 192 requests: launches exact per forward
              (Faster-RCNN: 6 attention at Sk=16 and 7 bottleneck; cross:
              24 attention, 12 at S=213 and 12 at S=197), finite log-probs
              whose rows sum to one and give the served top-k, kernels on
              against off (bf16 over the three chunks, fp32 on one); then
              ``ask_batch`` times with the kernels on and off in turns,
              FAMILY_ROUNDS times each, and a profile of one forward of
              each (device time, launches, idle share).
6. train   -- the CNN family's training path at the same width, B=64,
              bf16 compute with fp32 master weights: one epoch (8 train and
              2 test batches) through ``VQATrainer`` with the reference
              config's optimizer, dropout and frozen-feature cache, checking
              finite losses, the launches (21 bottleneck for the cache's
              build over 192 images in 3 chunks of 64; 0 and 0 per train
              step; 6 attention and 0 bottleneck per eval forward), the log
              lines, the validation predictions and a strict reload of
              ``best-model.pt``; the cache on against off over 2 steps at
              dropout 0 (losses within 2e-4 relative); kernels on against
              off at dropout 0 with the cache off (5 bf16 steps; 3 fp32
              steps on a repeated batch, whose loss must fall; 6 attention
              and 7 bottleneck launches per step); then train-step timings
              with the cache off (so that the bottleneck kernel runs in the
              timed step) with the kernels on and off in turns, and a
              profile of each (device time and launches of the tower, the
              text tower, the forward and the step; idle share).
7. train_vit -- the ViT family's training path at full width (ViT-base +
              T5-base encoder-decoder, 170 answers, B=64, bf16 compute with
              fp32 master weights, 224^2 seeded uint8 images): one epoch
              through ``VQATrainer`` with the reference config's optimizer,
              production dropout (T5 0.1, fusing layer 0.5) and the cache on
              (36 attention launches for the build, 0 per step), checking
              the log lines, the validation predictions and a strict reload
              of ``best-model.pt``; the cache on against off over 2 steps
              at dropout 0; kernels on against off at dropout 0 with the
              cache off (12 attention launches per step; bf16 over 5 steps,
              fp32 over 3 on a repeated batch); 2 steps of a fine-tuned
              tower with the kernels on and off (12 kernel forwards per
              step and their backward); then train-step timings of the
              cached, the cache-off and the fine-tuned variants in turns,
              and a profile of each.
8. train_frcnn, train_cross -- each family at the same width through
              ``VQATrainer`` for one epoch with the reference config
              (production dropout, B=64, bf16 compute with fp32 master
              weights): Faster-RCNN with the cache on (21 bottleneck
              launches build it from the FPN's pool level, 0 per step, 6
              attention per eval forward); cross-attention with the cache
              off and JAX's log line (24 attention launches per step and
              per eval forward, and 12 attention VJPs per step: the RoBERTa
              layers train, the frozen ViT's run without a gradient). Then
              the cache on against off (Faster-RCNN), kernels on against
              off at dropout 0 (Faster-RCNN with the cache off: 6 attention
              and 7 bottleneck launches per step; cross: 24), and
              train-step timings (Faster-RCNN cached and cache-off; cross
              production), FAMILY_TRAIN_ROUNDS each, with a profile of
              each.
9. resume  -- kill and resume, for each family at full width (B=64, bf16
              compute; the CNN family with the cache off, so that its
              steps run the bottleneck kernel; the ViT family with the
              cache on, the production setting): a child process
              (``chip_smoke.py --resume-child``) trains with
              ``checkpoint_every_steps=3`` and SIGKILLs itself after the
              params ``.next`` of its second pair has landed and before the
              state ``.next`` (the worst crash window). An uninterrupted
              trainer with the same seed takes the same 3 steps and one more
              at dropout 0 on a fixed batch. A trainer with
              ``load_from_checkpoint`` must then adopt the first pair (step
              3) and throw away the lone params ``.next``, hold model and
              optimizer state equal to the pair's files to the bit on the
              card, set the LRs of the schedule at step 3, and take the same
              dropout-0 step: loss and update (L2) within 1e-6 relative of
              the uninterrupted run's. Launches are counted per resumed
              production step (7 bottleneck for the CNN family; 0 for the
              cached ViT family) and for the ViT cache's rebuild (36
              attention). The line gives the pair's bytes, a synchronous
              pair save's seconds, ``_try_resume``'s seconds and the step
              time with and without a background pair save in flight (in
              turns). One CNN epoch with ``trace_dir`` set (2 steps, dropout
              0, the cache off) must write a trace naming both kernels.
10. serve_from_checkpoint -- for each of the four families: 2 train
              steps, ``best-model.pt``
              through the callbacks, then ``VQAInferenceSession.
              from_checkpoint`` (timed); ``ask_batch`` on 64 requests must
              give the trainer's eval-step log-probs on the same requests,
              collated as the session collates them, within 1e-3, the same
              top-1 answers, and 6 attention and 7 bottleneck launches (CNN
              and Faster-RCNN), 12 attention launches (ViT) or 24
              (cross-attention). The difference from the
              trainer's own validation batch, whose ViT question columns
              are trimmed to the longest question, is reported.

Prints one JSON line per phase, then the card's name and power limit as
nvidia-smi reports them, then the kernels line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.

In the kernels line, ``launches`` is the count over the three served
forwards of the CNN family (``vit_launches`` over the ViT family's three,
``train_epoch_launches`` and ``vit_train_epoch_launches`` over each
family's training epoch, the cache's build included,
``train_launches_per_step`` and ``vit_train_launches_per_step`` per step of
each variant and for the cache's build, ``resume_launches`` per resumed
step and per cache rebuild, ``serve_from_checkpoint_launches`` over the
64 requests served from a checkpoint; ``frcnn_launches`` and
``cross_launches`` over each family's three served forwards,
``frcnn_train_epoch_launches`` / ``cross_train_epoch_launches`` and
``frcnn_train_launches_per_step`` / ``cross_train_launches_per_step``
likewise, the latter with the attention VJPs of a production step);
``ms``, ``plain_ms``, ``bound_ms``, ``library_ms`` and attention's
``bwd_ms`` are per forward (``bound_share`` is ``bound_ms / ms``):
the bf16 times of the kernel phase summed over the shapes one
forward launches (attention: 5 at Sk=16 and 1 at Sk=64; bottleneck: the
seven blocks of stages 0 and 1); ``max_abs_err`` is the largest of those
cases. Attention's ``vit_ms``, ``vit_plain_ms``, ``vit_bound_ms`` and
``vit_library_ms`` are per launch at the ViT shape (B=64, H=12, S=197,
D=64, bf16), and so are ``vit_bwd_ms`` and ``vit_plain_bwd_ms``; the
``cross_*`` numbers likewise at the RoBERTa shape (B=64, H=12, S=213,
D=64, bf16). Bounds are the larger of bytes over 3.35 TB/s and FLOPs over
the dtype's peak (989 TFLOP/s bf16, 67 TFLOP/s fp32), H100 SXM data sheet.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor cores
              "float32": 67e12}       # CUDA cores (the fp32 path uses no TF32)
ATT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGPROB_TOL = {"float32": 1e-3, "bfloat16": 5e-2}

DEVICE = "cuda"
BATCH = 64
CHUNKS = 3
# timed rounds per configuration of the serving phases (20 and 10 before
# the ViT family's training phase joined the run, 10 and 6 before the
# Faster-RCNN and cross-attention phases did; lowered to keep the whole run
# under 800 s)
ROUNDS = 6             # ask_batch, CNN family
VIT_ROUNDS = 4         # ask_batch and generate_batch, ViT family
FAMILY_ROUNDS = 4      # ask_batch, Faster-RCNN and cross-attention families
GEN_TOKENS = 5         # generate_batch: answer length and beams
GEN_BEAMS = 3
BEAM_SCORE_TOL = 1e-4  # fp32 beam scores, kernels on against off
PROFILE_TRIES = 3
ANSWERS = 170          # the DAQUAR answer-space size
IMAGE = 256
VIT_IMAGE = 224
VIT_NAME = "google/vit-base-patch16-224-in21k"
# the cross-attention family: RoBERTa over 197 image and 16 question tokens
CROSS_SEQ = 197 + 16

TRAIN_BATCHES = 8      # the train phase's epoch: 8 train and 2 test batches
TEST_BATCHES = 2
DISTINCT_IMAGES = 96   # per split; DAQUAR asks several questions per image
BF16_STEPS = 5         # kernels on against off, dropout 0
FP32_STEPS = 3
# timed train steps per configuration, in turns (20 before the
# Faster-RCNN and cross-attention phases joined the run)
TRAIN_ROUNDS = 12
FAMILY_TRAIN_ROUNDS = 6   # the same, Faster-RCNN and cross-attention
# profiled train steps per configuration: the device's idle share and the
# step's busy time and launches (10 before the ViT family's training phase
# joined the run; the profiler's bookkeeping of a step's ~3000-6000 kernels
# and their host operators took ~5 s per step)
TRAIN_WINDOW = 3
# kernels on against off, same weights and batches, dropout 0. bf16: the
# mean NLL may differ by what the forward's log-probs may (LOGPROB_TOL, the
# serve phase's: t1/t2 and the probabilities re-rounded to bf16 in other
# places), and the updates that follow differ by as little. fp32, no TF32:
# losses 1e-4 relative (sums in another order); the difference of the
# trainable parameters within 1e-2 of their update (L2 over all of them):
# AdamW divides each update by the root of its second moment, so an element
# whose gradient is near 0 moves by its LR in the direction of its sign,
# which a sum in another order can flip. Each flip adds 2 LR; 1e-2 leaves
# room for thousands of flips among ~150 M parameters, while a module with
# a wrong gradient moves a whole share of the update.
TRAIN_LOSS_TOL = {"bfloat16": LOGPROB_TOL["bfloat16"], "float32": 1e-4}
UPDATE_TOL = 1e-2
# the comparisons' LRs: small enough for 5 bf16 steps to stay comparable,
# large enough (the classifier's) for the loss on a repeated batch to fall
PARITY_LRS = {"lm_encoder_lr": 1e-4, "fusion_lr": 1e-4, "classifier_lr": 1e-3}
CACHE_STEPS = 2        # the cache on against off, dropout 0
# losses with the cache on against off, relative: the cache holds the
# tower's own features, so only sums in another order may differ (the JAX
# package's bound for the same comparison, tests/test_feature_cache.py:141)
CACHE_TOL = 2e-4
FINE_TUNED_STEPS = 2


T0 = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON line, with the seconds since the script started."""
    record["elapsed_s"] = time.perf_counter() - T0
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
    ("cross_s213", BATCH, 12, CROSS_SEQ, CROSS_SEQ, 64, 0),
]
# the kernel phase's per-launch numbers kept for the kernels line, by case
PER_LAUNCH_CASES = {"vit_s197": "vit", "cross_s213": "cross"}


def phase_attention(torch):
    import torch.nn.functional as F
    from t5_resnet_vqa_torch.ops import attention as A

    per_forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0,
                   "library_ms": 0.0, "max_abs_err": 0.0, "bwd_ms": 0.0,
                   "plain_bwd_ms": 0.0, "bwd_max_abs_err": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for name, B, H, Sq, Sk, D, n_fwd in ATTENTION_CASES:
            g = torch.Generator(device=DEVICE).manual_seed(1)
            q = torch.randn(B, H, Sq, D, device=DEVICE, generator=g).to(dtype)
            k = torch.randn(B, H, Sk, D, device=DEVICE, generator=g).to(dtype)
            v = torch.randn(B, H, Sk, D, device=DEVICE, generator=g).to(dtype)
            # the main path's inputs: head views of [B, S, H*D] projections
            qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                          for t in (q, k, v))
            abs_err = rel = 0.0
            for args in ((q, k, v), (qv, kv, vv)):
                got = A.fused_attention(*args)
                want = A.attention_reference(*args)
                torch.cuda.synchronize()
                a, r = rel_err(got, want)
                if not r <= ATT_TOL[dtype_name]:
                    raise AssertionError(
                        f"attention {name} {dtype_name}: max-abs error "
                        f"{a} ({r} of max|ref|) > {ATT_TOL[dtype_name]}")
                abs_err, rel = max(abs_err, a), max(rel, r)
            ms = device_ms(torch, lambda: A.fused_attention(q, k, v))
            views_ms = device_ms(torch, lambda: A.fused_attention(qv, kv, vv))
            plain_ms = device_ms(torch,
                                 lambda: A.attention_reference(q, k, v))
            lib_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            t_bytes, t_ops = bound_terms(nbytes, 4.0 * B * H * Sq * Sk * D,
                                         dtype_name)
            line = {"phase": "kernel", "kernel": "attention", "case": name,
                    "dtype": dtype_name, "shape": [B, H, Sq, Sk, D],
                    "max_abs_err": abs_err, "rel_err": rel,
                    "tol": ATT_TOL[dtype_name], "ms": ms,
                    "ms_head_views": views_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                    "bound_share": max(t_bytes, t_ops) / ms,
                    "bound_by": bound_by(t_bytes, t_ops)}
            # every shape is on a training path: the SGA's at dropout 0,
            # the ViT's with the cache off or a fine-tuned tower
            line.update(attention_backward(torch, A, B, H, Sq, Sk, D,
                                           dtype, dtype_name, name))
            emit(line)
            if dtype_name == "bfloat16" and name in PER_LAUNCH_CASES:
                per_forward[PER_LAUNCH_CASES[name]] = {
                    "ms": ms, "ms_head_views": views_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": bound_by(t_bytes, t_ops),
                    "max_abs_err": abs_err, "bwd_ms": line["bwd_ms"],
                    "plain_bwd_ms": line["plain_bwd_ms"],
                    "bwd_max_abs_err": line["bwd_max_abs_err"]}
            if dtype_name == "bfloat16" and n_fwd:
                per_forward["ms"] += n_fwd * ms
                per_forward["plain_ms"] += n_fwd * plain_ms
                per_forward["library_ms"] += n_fwd * lib_ms
                per_forward["bwd_ms"] += n_fwd * line["bwd_ms"]
                per_forward["plain_bwd_ms"] += n_fwd * line["plain_bwd_ms"]
                add_bound(per_forward, n_fwd, t_bytes, t_ops)
                per_forward["max_abs_err"] = max(per_forward["max_abs_err"],
                                                 abs_err)
                per_forward["bwd_max_abs_err"] = max(
                    per_forward["bwd_max_abs_err"], line["bwd_max_abs_err"])
    return per_forward


def attention_backward(torch, A, B, H, Sq, Sk, D, dtype, dtype_name, name):
    """The kernel's backward (the VJP of the plain version) through the
    head views of [B, S, H*D] projections, as the SGA blocks and the ViT
    hand them over,
    against ``torch.autograd.grad`` of the plain version on the same inputs;
    with the device ms of each backward (the graph kept and run again)."""
    g = torch.Generator(device=DEVICE).manual_seed(6)
    projections = [torch.randn(B, s, H * D, device=DEVICE,
                               generator=g).to(dtype) for s in (Sq, Sk, Sk)]
    grad_out = torch.randn(B, H, Sq, D, device=DEVICE, generator=g).to(dtype)

    def graph(fn):
        leaves = [p.clone().requires_grad_() for p in projections]
        out = fn(*(x.reshape(B, -1, H, D).transpose(1, 2) for x in leaves))
        return lambda: torch.autograd.grad(out, leaves, grad_out,
                                           retain_graph=True)

    kernel_bwd, plain_bwd = graph(A.fused_attention), \
        graph(A.attention_reference)
    abs_err = rel = 0.0
    for got, want in zip(kernel_bwd(), plain_bwd()):
        a, r = rel_err(got, want)
        if not r <= ATT_TOL[dtype_name]:
            raise AssertionError(
                f"attention backward {name} {dtype_name}: max-abs error "
                f"{a} ({r} of max|ref|) > {ATT_TOL[dtype_name]}")
        abs_err, rel = max(abs_err, a), max(rel, r)
    return {"bwd_max_abs_err": abs_err, "bwd_rel_err": rel,
            "bwd_ms": device_ms(torch, kernel_bwd),
            "plain_bwd_ms": device_ms(torch, plain_bwd)}


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
            packed = block.fused          # packed once, as on the main path
            ops = packed.plain
            got = K.fused_bottleneck_packed(x, packed, stride=stride)
            want = K.bottleneck_reference(x, *ops, stride=stride)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            if not rel <= BLOCK_TOL[dtype_name]:
                raise AssertionError(
                    f"bottleneck {name} {dtype_name}: max-abs error "
                    f"{abs_err} ({rel} of max|ref|) > {BLOCK_TOL[dtype_name]}")
            ms = device_ms(torch, lambda: K.fused_bottleneck_packed(
                x, packed, stride=stride))
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
                  "bound_share": max(t_bytes, t_ops) / ms,
                  "bound_by": bound_by(t_bytes, t_ops),
                  "weight_stream_mb": streamed_weight_bytes(
                      H, cin, width, stride, ds, x.element_size()) / 1e6})
            if dtype_name == "bfloat16":
                per_forward["ms"] += n_fwd * ms
                per_forward["plain_ms"] += n_fwd * plain_ms
                add_bound(per_forward, n_fwd, t_bytes, t_ops)
                per_forward["max_abs_err"] = max(per_forward["max_abs_err"],
                                                 abs_err)
    return per_forward


def streamed_weight_bytes(H, cin, cw, stride, ds, itemsize) -> float:
    """Weight bytes one launch streams from L2, by the shapes: every
    output tile (8x16 pixels at stride 1, 4x16 at stride 2 in bf16; 4x16 in
    fp32) reads its 64-row chunks once (w1 once per 192-row conv1 pass in
    bf16, per 64-row pass in fp32); bf16 rows carry their 8 padding zeros."""
    th, tw = (8 if stride == 1 and itemsize == 2 else 4), 16
    ho = H // stride
    tiles = BATCH * -(-ho // th) * -(-ho // tw)
    halo = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
    passes = -(-halo // (192 if itemsize == 2 else 64))
    cout = 4 * cw
    pad = 8 if itemsize == 2 else 0
    small = 64 * (cw + pad) * itemsize          # a w1 / w2 chunk
    big = 64 * (128 + pad) * itemsize           # a w3 / wd chunk
    per_tile = (passes * (cin // 64) * small + 9 * (cw // 64) * small
                + (cout // 128) * ((cw // 64) + (cin // 64 if ds else 0)) * big)
    return float(tiles * per_tile)


def _build_model(torch, dtype, use_kernels, dropout=True):
    """The flagship at full width, weights from a generator seeded with 0;
    ``dropout=False`` sets the T5 and SGA dropout rates to 0."""
    from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
    from t5_resnet_vqa_torch.ops import AttentionConfig

    rate = {} if dropout else {"dropout_rate": 0.0}
    return ResnetVQAModel(
        ANSWERS, vision_model_name="resnet50",
        t5_config=T5Config(**rate), num_attention_blocks=3,
        sga_config=AttentionConfig(**rate), use_kernels=use_kernels,
        dtype=dtype, device=DEVICE, generator=torch.Generator().manual_seed(0))


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
    bf16_diff = check_served(session, plain, batches, results, "CNN")

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
        phase_breakdown(torch, "breakdown", label,
                        cnn_parts(s.model, batches[0]), card)

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


def check_served(session, plain, batches, results, what):
    """Each served chunk's bf16 log-probs: [BATCH, ANSWERS], finite, rows
    summing to one within 1e-3, giving the served top-3 probabilities, and
    within LOGPROB_TOL of the same weights with the kernels off (the
    session ``plain``). Returns the largest on/off difference."""
    bf16_diff = 0.0
    for c, batch in enumerate(batches):
        lp = session._predict(batch).cpu().numpy()
        if lp.shape != (BATCH, ANSWERS) or not np.isfinite(lp).all():
            raise AssertionError(f"{what} log-probs of shape {lp.shape}, "
                                 f"finite={np.isfinite(lp).all()}")
        sums = np.exp(lp.astype(np.float64)).sum(-1)
        if not np.abs(sums - 1.0).max() <= 1e-3:
            raise AssertionError(f"{what} probabilities sum to "
                                 f"{sums.min()}..{sums.max()}")
        served = np.array([r["top_probs"]
                           for r in results[c * BATCH:(c + 1) * BATCH]])
        top = np.exp(np.sort(lp, axis=-1)[:, ::-1][:, :3])
        # the same inputs through the same model; 1e-4 leaves room for a
        # library that sums in another order from one call to the next
        if not np.abs(served - top).max() <= 1e-4:
            raise AssertionError(f"{what} served top-k probabilities differ "
                                 f"from the forward's log-probs")
        off = plain._predict(batch).cpu().numpy()
        bf16_diff = max(bf16_diff, float(np.abs(lp - off).max()))
    if not bf16_diff <= LOGPROB_TOL["bfloat16"]:
        raise AssertionError(f"{what} bf16 kernels on/off log-probs differ "
                             f"by {bf16_diff} > {LOGPROB_TOL['bfloat16']}")
    return bf16_diff


def serve_ms(torch, session, requests):
    """(milliseconds on the host clock of one ``ask_batch`` over
    ``requests``, which reads every answer back, and its answers)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = session.ask_batch(requests, top_k=3)
    return (time.perf_counter() - t0) * 1e3, results


def cnn_parts(model, batch):
    """The CNN family's forward and two of its parts, for ``phase_breakdown``:
    the vision tower and the text tower (the rest is the projection, SGA and
    head)."""
    return {
        "vision": lambda: model.compute_vision_features(batch["image_tensors"]),
        "text": lambda: model.lang_model(batch["question_input_ids"],
                                         batch["question_attention_masks"]),
        "forward": lambda: model(**batch),
    }


def phase_breakdown(torch, phase, label, parts, card):
    """Where one bf16 forward's time goes. ``parts`` maps a name to a call of
    one part of the forward and ``"forward"`` to the whole forward. For
    each: its CUDA-event time (``rest_ms`` is the forward's less the parts')
    and, from the profiler, the device time of its kernels (kernel rows
    only: an operator row repeats its kernels' time) and how many it
    launched; the pairs/s of back-to-back forwards; the device's idle share
    over 10 back-to-back forwards, with its busy time and its elapsed time
    both taken in one profiled window (the profiler's own host work is in
    that window); the forward's busiest kernels. Emits the line and returns
    it."""
    with torch.inference_mode():
        wall = {name: cuda_ms(torch, fn, iters=10)
                for name, fn in parts.items()}
        device = {name: profile_device(torch, fn, iters=1)
                  for name, fn in parts.items()}
        window = profile_device(torch, parts["forward"], iters=10)
    line = {"phase": phase, "config": label, "card": card,
            "batch": BATCH, "dtype": "bfloat16",
            "forward_pairs_per_s": BATCH / (wall["forward"] / 1e3),
            "event_ms": wall,
            "rest_ms": wall["forward"] - sum(v for k, v in wall.items()
                                             if k != "forward"),
            "device_busy_ms": {k: v["busy_ms"] for k, v in device.items()},
            "kernel_launches": {k: v["launches"] for k, v in device.items()},
            "device_idle_share": 1.0 - window["busy_ms"] / window["elapsed_ms"],
            "idle_window": {"forwards": 10, "busy_ms": window["busy_ms"],
                            "elapsed_ms": window["elapsed_ms"]},
            "top_kernels": [{"us": us, "calls": n, "name": name}
                            for us, n, name in
                            device["forward"]["kernels"][:12]]}
    emit(line)
    return line


def _build_vit_model(torch, dtype, use_kernels, dropout=True,
                     fine_tune_vision=False):
    """ViT-base + T5-base encoder-decoder at full width, weights from a
    generator seeded with 0; ``dropout=False`` sets the T5 and fusing-layer
    dropout rates to 0."""
    from t5_resnet_vqa_torch.models import T5Config, VitVQAModel

    rates = {} if dropout else {"fusing_dropout": 0.0}
    return VitVQAModel(ANSWERS, use_kernels=use_kernels, dtype=dtype,
                       t5_config=T5Config(**({} if dropout else
                                             {"dropout_rate": 0.0})),
                       fine_tune_vision=fine_tune_vision, device=DEVICE,
                       generator=torch.Generator().manual_seed(0), **rates)


def _generate(session, requests, num_beams):
    """``generate_batch`` with the hash tokenizer's warning silenced (the
    card's machine has no real tokenizer; the ids are what is compared)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return session.generate_batch(requests, num_beams=num_beams,
                                      max_answer_length=GEN_TOKENS)


def _padded_tokens(results):
    return np.array([r["token_ids"] + [0] * (GEN_TOKENS - len(r["token_ids"]))
                     for r in results])


def phase_serve_vit(torch, card):
    """The ViT family behind ``ask_batch`` and ``generate_batch`` at full
    width (see the module docstring). Returns the kernels' launches over
    the three served forwards."""
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K

    t_phase = time.perf_counter()
    answers = [f"answer{i:03d}" for i in range(ANSWERS)]
    rng = np.random.default_rng(2)
    objects = ["table", "chair", "lamp", "sofa", "bottle", "book", "cup"]
    requests = [(f"vit_request_{i}.png",
                 f"what is on the {objects[int(rng.integers(len(objects)))]}"
                 f" number {i % BATCH}") for i in range(CHUNKS * BATCH)]
    size = 224
    images = {path: rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for path, _ in requests}

    def load_images(paths):
        return np.stack([images[p] for p in paths])

    def serving(dtype, use_kernels, state=None):
        model = _build_vit_model(torch, dtype, use_kernels)
        session = VQAInferenceSession(model, state, answers, "vit",
                                      batch_size=BATCH, device=DEVICE)
        session.collate.load_images = load_images
        return session

    session = serving(torch.bfloat16, True)
    session.ask_batch(requests[:BATCH])       # first call: allocator, cuDNN
    torch.cuda.synchronize()

    # the main path once: three chunks of requests, counts read right after
    A.launches = 0
    K.launches = 0
    first_ms, results = serve_ms(torch, session, requests)
    launches = {"attention": A.launches, "bottleneck": K.launches}
    if launches != {"attention": 12 * CHUNKS, "bottleneck": 0}:
        raise AssertionError(f"ViT launch counts {launches}, expected 12 "
                             f"attention per forward over {CHUNKS} forwards")
    if len(results) != len(requests) or \
            not all(r["answer"] in answers for r in results):
        raise AssertionError("answers missing or outside the answer space")

    plain = serving(torch.bfloat16, False, state=session.model.state_dict())
    batches = [session._to_device(session._collate_chunk(
        requests[c * BATCH:(c + 1) * BATCH])) for c in range(CHUNKS)]
    bf16_diff = check_served(session, plain, batches, results, "ViT")

    # generation on one chunk; bf16 greedy agreement is reported, not gated
    chunk = requests[:BATCH]
    A.launches = 0
    greedy_bf16 = {flag: _padded_tokens(_generate(s, chunk, 1))
                   for flag, s in ((True, session), (False, plain))}
    gen_launches = A.launches
    if gen_launches != 12:
        raise AssertionError(f"greedy generate_batch on one chunk launched "
                             f"attention {gen_launches} times, expected 12 "
                             f"(one tower forward)")
    bf16_equal = float((greedy_bf16[True] == greedy_bf16[False]).mean())

    # timings: kernels on and off in turns
    rounds = {"ask_batch": {"kernels_on": [], "kernels_off": []},
              "greedy": {"kernels_on": [], "kernels_off": []},
              "beam": {"kernels_on": [], "kernels_off": []}}
    calls = {"ask_batch": lambda s: s.ask_batch(requests, top_k=3),
             "greedy": lambda s: _generate(s, chunk, 1),
             "beam": lambda s: _generate(s, chunk, GEN_BEAMS)}
    for r in range(VIT_ROUNDS):
        order = (("kernels_on", session), ("kernels_off", plain))
        for label, s in (order if r % 2 == 0 else order[::-1]):
            for what, fn in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(s)
                rounds[what][label].append((time.perf_counter() - t0) * 1e3)
    sessions = (("kernels_on", session), ("kernels_off", plain))
    breakdown = {label: phase_breakdown(torch, "breakdown_vit", label,
                                        vit_parts(torch, s.model, batches[0]),
                                        card)
                 for label, s in sessions}
    # one profiled generate_batch of each kind on one chunk: the device's
    # busy time, its launches and its idle share over the call
    generation = {}
    for what in ("greedy", "beam"):
        for label, s in sessions:
            prof = profile_device(torch, lambda: calls[what](s))
            generation.setdefault(what, {})[label] = {
                "busy_ms": prof["busy_ms"], "elapsed_ms": prof["elapsed_ms"],
                "launches": prof["launches"],
                "device_idle_share": 1.0 - prof["busy_ms"] / prof["elapsed_ms"]}

    # fp32 (no TF32): log-probs, greedy tokens and beams, on one chunk
    state = session.model.state_dict()
    del session, plain
    torch.cuda.empty_cache()
    fp32 = {}
    for flag in (True, False):
        s = serving(torch.float32, flag, state=state)
        A.launches = 0
        with torch.inference_mode():
            lp = s.model(**batches[0])[0]
        if A.launches != (12 if flag else 0):
            raise AssertionError(f"fp32 forward with use_kernels={flag} "
                                 f"launched attention {A.launches} times")
        fp32[flag] = (lp, _generate(s, chunk, 1), _generate(s, chunk,
                                                            GEN_BEAMS))
        del s
        torch.cuda.empty_cache()
    fp32_diff = float((fp32[True][0] - fp32[False][0]).abs().max())
    if not fp32_diff <= LOGPROB_TOL["float32"]:
        raise AssertionError(f"ViT fp32 kernels on/off log-probs differ by "
                             f"{fp32_diff} > {LOGPROB_TOL['float32']}")
    for i, what in ((1, "greedy"), (2, "beam")):
        on = [r["token_ids"] for r in fp32[True][i]]
        off = [r["token_ids"] for r in fp32[False][i]]
        if on != off:
            diff = sum(a != b for a, b in zip(on, off))
            raise AssertionError(f"fp32 {what} tokens differ with the "
                                 f"kernels on and off in {diff} rows")
    score_diff = float(np.abs(np.array([r["score"] for r in fp32[True][2]])
                              - np.array([r["score"]
                                          for r in fp32[False][2]])).max())
    if not score_diff <= BEAM_SCORE_TOL:
        raise AssertionError(f"fp32 beam scores on/off differ by "
                             f"{score_diff} > {BEAM_SCORE_TOL}")
    lengths = [len(r["token_ids"]) for r in fp32[True][2]]
    if max(len(r["token_ids"]) for r in fp32[True][1]) < 2:
        raise AssertionError("fp32 greedy generation stopped after one token "
                             "in every row")

    median = {what: {label: float(np.median(ms)) for label, ms in d.items()}
              for what, d in rounds.items()}
    pairs = len(requests)
    emit({"phase": "serve_vit", "card": card,
          "model": "vit-base + t5-base enc-dec", "answers": ANSWERS,
          "dtype": "bfloat16", "batch": BATCH, "requests": pairs,
          "launches": launches, "first_run_ms": first_ms,
          "ask_batch_ms": median["ask_batch"]["kernels_on"],
          "pairs_per_s": pairs / (median["ask_batch"]["kernels_on"] / 1e3),
          "kernels_off_ask_batch_ms": median["ask_batch"]["kernels_off"],
          "kernels_off_pairs_per_s":
              pairs / (median["ask_batch"]["kernels_off"] / 1e3),
          "generate_batch_ms_per_chunk": {
              what: median[what] for what in ("greedy", "beam")},
          "fastest_ms": {what: {label: float(min(ms))
                                for label, ms in d.items()}
                         for what, d in rounds.items()},
          "rounds": VIT_ROUNDS, "rounds_ms": rounds,
          "generate": {"max_answer_length": GEN_TOKENS, "beams": GEN_BEAMS,
                       "attention_launches_greedy_chunk": gen_launches,
                       "bf16_greedy_equal_token_share": bf16_equal,
                       "fp32_greedy_equal": True, "fp32_beam_equal": True,
                       "fp32_beam_score_diff": score_diff,
                       "fp32_beam_lengths": [min(lengths), max(lengths)]},
          "logprob_diff_bf16": bf16_diff, "logprob_diff_fp32": fp32_diff,
          "device_busy_ms": {k: v["device_busy_ms"]
                             for k, v in breakdown.items()},
          "kernel_launches": {k: v["kernel_launches"]
                              for k, v in breakdown.items()},
          "device_idle_share": {k: v["device_idle_share"]
                                for k, v in breakdown.items()},
          "generate_profile": generation,
          "sample_answer": results[0],
          "sample_generation": fp32[True][2][0],
          "seconds": time.perf_counter() - t_phase})
    return launches


def vit_parts(torch, model, batch):
    """The ViT family's forward and three of its parts, for
    ``phase_breakdown``: the tower, the T5 encoder and the decoder (the rest
    is the fusing layer and the head)."""
    with torch.inference_mode():
        fused = model.fuse(batch["question_input_ids"],
                           batch["question_attention_masks"],
                           batch["pixel_values"])
    return {
        "vision": lambda: model.compute_vision_features(batch["pixel_values"]),
        "text": lambda: model.lang_model.encoder(
            batch["question_input_ids"], batch["question_attention_masks"]),
        "decoder": lambda: model.decode_hidden(
            batch["decoder_question_input_ids"],
            batch["decoder_question_attention_masks"], fused),
        "forward": lambda: model(**batch),
    }


def _build_frcnn_model(torch, dtype, use_kernels, dropout=True):
    """ResNet-50 + FPN + T5-base + 3 SGA blocks at full width, weights from
    a generator seeded with 0; ``dropout=False`` sets the T5 and SGA
    dropout rates to 0."""
    from t5_resnet_vqa_torch.models import FasterRcnnVQAModel, T5Config
    from t5_resnet_vqa_torch.ops import AttentionConfig

    rate = {} if dropout else {"dropout_rate": 0.0}
    return FasterRcnnVQAModel(
        ANSWERS, t5_config=T5Config(**rate), num_attention_blocks=3,
        sga_config=AttentionConfig(**rate), use_kernels=use_kernels,
        dtype=dtype, device=DEVICE, generator=torch.Generator().manual_seed(0))


def _build_cross_model(torch, dtype, use_kernels, dropout=True):
    """ViT-base x RoBERTa-base, 12 interleaved layers, weights from a
    generator seeded with 0; ``dropout=False`` sets RoBERTa's hidden
    dropout to 0 (its attention has none)."""
    from t5_resnet_vqa_torch.models import (
        CrossAttentionVitVQAModel,
        RobertaConfig,
    )

    rate = {} if dropout else {"dropout_rate": 0.0}
    return CrossAttentionVitVQAModel(
        ANSWERS, roberta_config=RobertaConfig(**rate),
        use_kernels=use_kernels, dtype=dtype, device=DEVICE,
        generator=torch.Generator().manual_seed(0))


# the two families of this phase group: the session's family, the model's
# build function, image size, (attention, bottleneck) launches per forward, and
# the vision model name (and language model) of the trainer's config
FAMILIES = {
    "frcnn": {"session": "cnn", "build": _build_frcnn_model, "size": IMAGE,
              "launches": (6, 7), "vision": "faster-rcnn", "lang": "t5-base",
              "model": "resnet50-fpn + t5-base + 3xSGA"},
    "cross": {"session": "cross_attention", "build": _build_cross_model,
              "size": VIT_IMAGE, "launches": (24, 0), "vision": VIT_NAME,
              "lang": "roberta-base", "model": "vit-base x roberta-base"},
}


def family_parts(model, batch):
    """``phase_breakdown``'s parts: the Faster-RCNN family's are the CNN
    family's; the cross-attention family has no separable part."""
    if hasattr(model, "compute_vision_features"):
        return cnn_parts(model, batch)
    return {"forward": lambda: model(**batch)}


def phase_serve_family(torch, card, family):
    """``ask_batch`` of the Faster-RCNN (``frcnn``) or cross-attention
    (``cross``) family at full width (see the module docstring). Returns
    the kernels' launches over the three served forwards."""
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K

    spec = FAMILIES[family]
    t_phase = time.perf_counter()
    answers = [f"answer{i:03d}" for i in range(ANSWERS)]
    rng = np.random.default_rng(3)
    objects = ["table", "chair", "lamp", "sofa", "bottle", "book", "cup"]
    requests = [(f"{family}_request_{i}.png",
                 f"what is on the {objects[int(rng.integers(len(objects)))]}"
                 f" number {i % BATCH}") for i in range(CHUNKS * BATCH)]
    size = spec["size"]
    images = {path: rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
              for path, _ in requests}

    def load_images(paths):
        return np.stack([images[p] for p in paths])

    def serving(dtype, use_kernels, state=None):
        model = spec["build"](torch, dtype, use_kernels)
        session = VQAInferenceSession(model, state, answers, spec["session"],
                                      batch_size=BATCH, device=DEVICE)
        session.collate.load_images = load_images
        return session

    session = serving(torch.bfloat16, True)
    session.ask_batch(requests[:BATCH])       # first call: allocator, cuDNN
    torch.cuda.synchronize()

    # the main path once: three chunks of requests, counts read right after
    A.launches = 0
    K.launches = 0
    first_ms, results = serve_ms(torch, session, requests)
    launches = {"attention": A.launches, "bottleneck": K.launches}
    per_forward = dict(zip(("attention", "bottleneck"), spec["launches"]))
    if launches != {k: n * CHUNKS for k, n in per_forward.items()}:
        raise AssertionError(f"{family} launch counts {launches}, expected "
                             f"{per_forward} per forward over {CHUNKS} "
                             f"forwards")
    if len(results) != len(requests) or \
            not all(r["answer"] in answers for r in results):
        raise AssertionError("answers missing or outside the answer space")

    plain = serving(torch.bfloat16, False, state=session.model.state_dict())
    batches = [session._to_device(session._collate_chunk(
        requests[c * BATCH:(c + 1) * BATCH])) for c in range(CHUNKS)]
    bf16_diff = check_served(session, plain, batches, results, family)

    rounds = {"kernels_on": [], "kernels_off": []}
    sessions = (("kernels_on", session), ("kernels_off", plain))
    for r in range(FAMILY_ROUNDS):
        for label, s in (sessions if r % 2 == 0 else sessions[::-1]):
            rounds[label].append(serve_ms(torch, s, requests)[0])
    breakdown = {label: phase_breakdown(torch, f"breakdown_{family}", label,
                                        family_parts(s.model, batches[0]),
                                        card)
                 for label, s in sessions}

    # fp32 (no TF32), kernels on against off, on one chunk
    state = session.model.state_dict()
    del session, plain
    torch.cuda.empty_cache()
    fp32 = {}
    for flag in (True, False):
        m = spec["build"](torch, torch.float32, flag)
        m.load_state_dict(state, strict=True)
        a0, k0 = A.launches, K.launches
        with torch.inference_mode():
            fp32[flag] = m.eval()(**batches[0])[0]
        got = (A.launches - a0, K.launches - k0)
        if got != (spec["launches"] if flag else (0, 0)):
            raise AssertionError(f"{family} fp32 forward with use_kernels="
                                 f"{flag} launched {got}")
        del m
        torch.cuda.empty_cache()
    fp32_diff = float((fp32[True] - fp32[False]).abs().max())
    if not fp32_diff <= LOGPROB_TOL["float32"]:
        raise AssertionError(f"{family} fp32 kernels on/off log-probs differ "
                             f"by {fp32_diff} > {LOGPROB_TOL['float32']}")

    median = {label: float(np.median(ms)) for label, ms in rounds.items()}
    pairs = len(requests)
    emit({"phase": f"serve_{family}", "card": card, "model": spec["model"],
          "answers": ANSWERS, "dtype": "bfloat16", "batch": BATCH,
          "requests": pairs, "launches": launches,
          "launches_per_forward": per_forward, "first_run_ms": first_ms,
          "ask_batch_ms": median["kernels_on"],
          "pairs_per_s": pairs / (median["kernels_on"] / 1e3),
          "kernels_off_ask_batch_ms": median["kernels_off"],
          "kernels_off_pairs_per_s": pairs / (median["kernels_off"] / 1e3),
          "fastest_ask_batch_ms": {label: float(min(ms))
                                   for label, ms in rounds.items()},
          "rounds": FAMILY_ROUNDS, "rounds_ms": rounds,
          "logprob_diff_bf16": bf16_diff, "logprob_diff_fp32": fp32_diff,
          "device_busy_ms": {k: v["device_busy_ms"]
                             for k, v in breakdown.items()},
          "kernel_launches": {k: v["kernel_launches"]
                              for k, v in breakdown.items()},
          "device_idle_share": {k: v["device_idle_share"]
                                for k, v in breakdown.items()},
          "sample_answer": results[0],
          "seconds": time.perf_counter() - t_phase})
    return launches


def profile_device(torch, fn, iters: int = 1) -> dict:
    """``iters`` back-to-back calls of ``fn`` under the profiler. Per call:
    ``busy_ms`` (the device time of the profiler's kernel rows),
    ``launches`` and ``elapsed_ms`` (CUDA events around the calls, in the
    same window); and ``kernels``, [(us, calls, name)] busiest first over
    the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the profiler now and then returns a window without its device rows;
    # such a window is taken again, up to PROFILE_TRIES times in all
    for _ in range(PROFILE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
        # a record_function range (the optimizer's step) also has a device
        # row, spanning its kernels: it is not a kernel and is left out
        kernels = sorted(((e.self_device_time_total, e.count, e.key[:90])
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)
                          and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(k[0] for k in kernels) / 1e3
        if busy_ms > 0:
            break
    else:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{PROFILE_TRIES} windows")
    return {"busy_ms": busy_ms / iters,
            "launches": sum(k[1] for k in kernels) / iters,
            "elapsed_ms": start.elapsed_time(end) / iters,
            "kernels": kernels}


@contextlib.contextmanager
def seeded_images(load_images):
    """Every collate's image loading is ``load_images`` inside the block:
    the card's machine has no image decoder, so seeded uint8 images stand
    in for the files (the CPU tests cover decoding). A trainer builds its
    collates and its feature cache in its constructor, so the replacement
    is made on the class."""
    from t5_resnet_vqa_torch.data import DaquarCollateBase

    saved = DaquarCollateBase.load_images
    DaquarCollateBase.load_images = lambda self, paths: load_images(paths)
    try:
        yield
    finally:
        DaquarCollateBase.load_images = saved


def train_data(n_train, n_test, size=IMAGE):
    """(answers, train samples, test samples, load_images): DAQUAR-shaped
    questions with one or two answers each, over DISTINCT_IMAGES images per
    split, and seeded uint8 images of ``size``^2 standing in for the image
    files."""
    from t5_resnet_vqa_torch.data import Annotation, Question, Sample

    answers = [f"answer{i:03d}" for i in range(ANSWERS)]
    rng = np.random.default_rng(1)
    objects = ["table", "chair", "lamp", "sofa", "bottle", "book", "cup"]
    images = {}

    def split(name, n):
        samples = []
        for i in range(n):
            path = f"{name}_{i % DISTINCT_IMAGES}.png"
            if path not in images:
                images[path] = rng.integers(0, 256, (size, size, 3),
                                            dtype=np.uint8)
            obj = objects[int(rng.integers(len(objects)))]
            picks = [answers[int(rng.integers(ANSWERS))]
                     for _ in range(1 + int(rng.integers(2)))]
            samples.append(Sample(
                Question(f"what is on the {obj} number {i % 17}",
                         f"{name}_{i}_Question", path),
                Annotation(f"{name}__{i}_Question", path, picks), path))
        return samples

    def load_images(paths):
        return np.stack([images[p] for p in paths])

    return (answers, split("train", n_train * BATCH),
            split("test", n_test * BATCH), load_images)


def train_config(output_dir, vision="resnet50", lang="t5-base"):
    """The reference config's optimizer, schedule, callbacks and
    frozen-feature cache for the ``vision`` and ``lang`` models at B=64,
    bf16 compute with fp32 master weights; threshold -1 makes every epoch
    save the best model."""
    from t5_resnet_vqa_torch.core import Config

    cfg = Config.from_json(os.path.join(REPO, "vit_daquar_config.json"))
    cfg.model.vision_model_name = vision
    cfg.model.language_model_name = lang
    cfg.model.compute_dtype = "bfloat16"
    dk, tk = cfg.dataset, cfg.trainer
    dk.train_batch_size = dk.test_batch_size = BATCH
    dk.image_size = IMAGE
    dk.uint8_wire_images = True
    dk.use_native_preprocessor = False
    tk.epochs = 1
    tk.output_dir = output_dir
    tk.device = DEVICE
    tk.load_from_checkpoint = False
    cfg.callbacks.threshold = -1.0
    if not tk.cache_frozen_features:
        raise AssertionError("the reference config no longer caches the "
                             "frozen tower's features")
    return cfg.validate()


def train_epoch(torch, cfg, build, data, expect, log_lines):
    """One epoch through ``VQATrainer``: the counts are set to 0 just before
    the trainer is built (its constructor builds the frozen-feature cache)
    and read just after ``train()``. ``expect`` gives the (attention,
    bottleneck) launches of the cache's build, of each train step and of
    each eval forward. Checks finite losses, the launches, ``log_lines`` in
    the log, the validation predictions and a strict reload of
    ``best-model.pt`` (eval log-probs within 1e-4). Returns the numbers for
    the phase's line and the reloaded model (bf16 compute, in train mode),
    which a later timing may reuse."""
    from t5_resnet_vqa_torch.data import to_device
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import VQATrainer
    from t5_resnet_vqa_torch.train.trainer import _device_batch, prepare_model

    answers, train_ds, test_ds, load_images = data
    out_dir = cfg.trainer.output_dir
    calls = {"train": [], "eval": []}

    def counted(kind, fn):
        def run(batch):
            a0, k0 = A.launches, K.launches
            out = fn(batch)
            calls[kind].append((A.launches - a0, K.launches - k0, out[0]))
            return out
        return run

    A.launches = 0
    K.launches = 0
    t0 = time.perf_counter()
    with seeded_images(load_images):
        trainer = VQATrainer(build(), cfg, answers, train_ds, test_ds)
        cache_build = (A.launches, K.launches)
        trainer.train_step = counted("train", trainer.train_step)
        trainer.eval_step = counted("eval", trainer.eval_step)
        trainer.train()
        epoch_s = time.perf_counter() - t0
        # without the cache, the test batch loads its images
        test_batch = _device_batch(to_device(
            next(iter(trainer.test_dataloader)), torch.device(DEVICE)))
    launches = {"attention": A.launches, "bottleneck": K.launches}
    counts = {"cache_build": [cache_build],
              "train": [c[:2] for c in calls["train"]],
              "eval": [c[:2] for c in calls["eval"]]}
    want = {"cache_build": [expect["cache_build"]],
            "train": [expect["train"]] * TRAIN_BATCHES,
            "eval": [expect["eval"]] * TEST_BATCHES}
    if counts != want:
        raise AssertionError(f"launches (attention, bottleneck): {counts}, "
                             f"expected {want}")
    losses = torch.stack([c[2] for c in calls["train"]]).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"train losses {losses.tolist()}")
    with open(trainer.logger.log_path) as f:
        log = f.read()
    for line in log_lines + ("Average WUPS Score", "Average Validation Loss",
                             "Saving new best-model"):
        if line not in log:
            raise AssertionError(f"the training log lacks {line!r}")
    cache_line = next(ln for ln in log.splitlines()
                      if "Frozen-feature cache:" in ln)
    with open(os.path.join(out_dir, "validation_predictions",
                           "0_validation_predictions.json")) as f:
        predictions = json.load(f)
    if len(predictions) != TEST_BATCHES * BATCH:
        raise AssertionError(f"{len(predictions)} validation predictions")

    # best-model.pt into a fresh model: the same eval log-probs
    state = torch.load(os.path.join(out_dir, "model_checkpoints",
                                    "best-model.pt"),
                       map_location="cpu", weights_only=True)
    fresh = prepare_model(build(), torch.device(DEVICE), torch.bfloat16)
    fresh.load_state_dict(state, strict=True)
    with torch.inference_mode(), torch.autocast(DEVICE,
                                                dtype=torch.bfloat16):
        got = fresh.eval()(**test_batch)[0]
        want_lp = trainer.model.eval()(**test_batch)[0]
    reload_diff = float((got - want_lp).abs().max())
    if not reload_diff <= 1e-4:
        raise AssertionError(f"best-model.pt reloaded gives log-probs "
                             f"{reload_diff} away")
    del trainer, state
    torch.cuda.empty_cache()
    return fresh.train(), {"launches": launches,
            "launches_cache_build": dict(zip(("attention", "bottleneck"),
                                             expect["cache_build"])),
            "launches_per_train_step": dict(zip(("attention", "bottleneck"),
                                                expect["train"])),
            "launches_per_eval_forward": dict(zip(("attention",
                                                   "bottleneck"),
                                                  expect["eval"])),
            "cache_log_line": cache_line, "losses": losses.tolist(),
            "epoch_s": epoch_s, "best_model_reload_logprob_diff": reload_diff,
            "validation_predictions": len(predictions)}


def cache_chunks(data) -> int:
    """The chunks in which the trainer builds its cache: the unique images
    of both splits in chunks of min(64, train rows) (192 images in 3 chunks
    of 64 at the smoke's sizes)."""
    _, train_ds, test_ds, _ = data
    images = {s.image_path for s in train_ds + test_ds}
    return -(-len(images) // min(64, len(train_ds)))


def raw_batches(torch, cfg, data, family, n):
    """The first ``n`` train batches with their images, on the device, with
    their ``_indices`` (the cached variant gathers by them)."""
    from t5_resnet_vqa_torch.data import DataLoader, to_device
    from t5_resnet_vqa_torch.train.trainer import build_collates

    answers, train_ds, _, load_images = data
    collate, _ = build_collates(cfg.dataset, answers, seed=0, family=family)
    collate.load_images = load_images
    return [to_device(b, torch.device(DEVICE))
            for b, _ in zip(DataLoader(train_ds, collate, BATCH), range(n))]


def cached_batches(torch, model, data, raws):
    """A feature cache over both splits built with ``model``, and ``raws``
    with the gathered ``vision_features`` in place of their images. Returns
    (batches, the build's (attention, bottleneck) launches)."""
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import build_feature_cache
    from t5_resnet_vqa_torch.train.trainer import _device_batch

    _, train_ds, test_ds, load_images = data
    a0, k0 = A.launches, K.launches
    built, why = build_feature_cache(model, [train_ds, test_ds], load_images,
                                     BATCH, compute_dtype=torch.bfloat16)
    if built is None:
        raise AssertionError(f"the feature cache was not built: {why}")
    launches = (A.launches - a0, K.launches - k0)
    cache, (rows, _), _ = built
    out = []
    for raw in raws:
        batch = {k: v for k, v in _device_batch(raw).items()
                 if k not in ("image_tensors", "pixel_values")}
        batch["vision_features"] = cache.gather(rows[raw["_indices"]])
        out.append(batch)
    return out, launches


def parity_config(cfg):
    import copy

    cfg = copy.deepcopy(cfg)
    for key, lr in PARITY_LRS.items():
        setattr(cfg.optimizer, key, lr)
    return cfg


def cache_parity(torch, cfg, build, data, raws):
    """The cache on against off over CACHE_STEPS steps at dropout 0, from
    the same weights (one model, its state restored between the runs) on
    the same batches, kernels on, bf16: losses within CACHE_TOL relative.
    Returns the line's numbers and the cached batches."""
    from t5_resnet_vqa_torch.train.trainer import _device_batch, prepare_model

    cfg = parity_config(cfg)
    model = prepare_model(build(), torch.device(DEVICE),
                          torch.bfloat16).train()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    cached, build_launches = cached_batches(torch, model, data, raws)
    plain = [_device_batch(r) for r in raws]
    off, off_counts = _steps(torch, cfg, model, torch.bfloat16,
                             plain[:CACHE_STEPS], CACHE_STEPS)
    model.load_state_dict(start)
    on, on_counts = _steps(torch, cfg, model, torch.bfloat16,
                           cached[:CACHE_STEPS], CACHE_STEPS)
    diff = max(abs(a - b) / abs(b) for a, b in zip(on, off))
    if not (np.isfinite(on + off).all() and diff <= CACHE_TOL):
        raise AssertionError(f"losses with the cache on {on} and off {off} "
                             f"differ by {diff} > {CACHE_TOL}")
    del model, start
    torch.cuda.empty_cache()
    return ({"steps": CACHE_STEPS, "losses_cache_on": on,
             "losses_cache_off": off, "loss_diff": diff, "tol": CACHE_TOL,
             "launches_per_step_cache_on": on_counts,
             "launches_per_step_cache_off": off_counts,
             "launches_cache_build": build_launches}, cached)


def phase_train(torch, card):
    """The CNN family's training path: one epoch through ``VQATrainer``
    (production dropout, bf16 compute, the cache on), the cache on against
    off, kernels on against off at dropout 0 with the cache off (bf16 and
    fp32), and train-step timings with the cache off and the kernels on and
    off in turns. Returns the launch counts of the epoch and per step."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.train.trainer import _device_batch, prepare_model

    data = train_data(TRAIN_BATCHES, TEST_BATCHES)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cfg = train_config(out_dir)
        reloaded, epoch = train_epoch(
            torch, cfg, lambda: _build_model(torch, torch.float32, True),
            data, {"cache_build": (0, 7 * cache_chunks(data)),
                   "train": (0, 0), "eval": (6, 0)},
            (f"Frozen-feature cache: {2 * DISTINCT_IMAGES} images",))
        del reloaded
        emit({"phase": "train_epoch", "card": card,
              "model": "resnet50 + t5-base + 3xSGA", "answers": ANSWERS,
              "dtype": "bfloat16 compute, fp32 master weights",
              "dropout": "production (T5 0.1, SGA 0.1)", "batch": BATCH,
              "train_steps": TRAIN_BATCHES, "eval_forwards": TEST_BATCHES,
              **epoch})

        raws = raw_batches(torch, cfg, data, "cnn", BF16_STEPS)
        build = lambda: _build_model(torch, torch.float32, True,
                                     dropout=False)
        cache, _ = cache_parity(torch, cfg, build, data, raws)
        emit({"phase": "train_cache", "card": card,
              "model": "resnet50 + t5-base + 3xSGA", **cache})
        batches = [_device_batch(r) for r in raws]
        timing = {}

        def time_pair(models, dropout, rounds):
            """The kernels on and off in turns, the cache off: the
            bottleneck kernel runs in the timed step."""
            timing[dropout] = train_timing(
                torch, cfg, {"kernels_on": (models[True], batches[0]),
                             "kernels_off": (models[False], batches[0])},
                card, "train_timing", dropout, rounds)

        # at dropout 0 the parity's bf16 pair is timed, attention on the
        # kernel
        parity = train_parity(
            torch, cfg, batches,
            lambda flag: _build_model(torch, torch.float32, flag,
                                      dropout=False), (6, 7),
            after_bf16=lambda models: time_pair(models, False,
                                                TRAIN_ROUNDS // 2))
        emit({"phase": "train_parity", "card": card, **parity})
        models = {flag: prepare_model(
            _build_model(torch, torch.float32, flag), torch.device(DEVICE),
            torch.bfloat16).train() for flag in (True, False)}
        time_pair(models, True, TRAIN_ROUNDS)
        del models
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    per_step = {}
    for i, name in enumerate(("attention", "bottleneck")):
        per_step[name] = {
            "cache_build": epoch["launches_cache_build"][name],
            "cached_production_dropout":
                epoch["launches_per_train_step"][name],
            "eval_forward_cached": epoch["launches_per_eval_forward"][name],
            "cache_off_production_dropout":
                timing[True]["kernels_on"]["launches_per_step"][name],
            "cache_off_dropout_0":
                timing[False]["kernels_on"]["launches_per_step"][name]}
    return {"epoch": epoch["launches"], "per_step": per_step}


def phase_train_vit(torch, card):
    """The ViT family's training path at full width (see the module
    docstring). Returns the launch counts of the epoch and per step."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.train.trainer import _device_batch, prepare_model

    t_phase = time.perf_counter()
    data = train_data(TRAIN_BATCHES, TEST_BATCHES, VIT_IMAGE)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_vit_")
    model_name = "vit-base + t5-base enc-dec"
    try:
        cfg = train_config(out_dir, VIT_NAME)
        reloaded, epoch = train_epoch(
            torch, cfg, lambda: _build_vit_model(torch, torch.float32, True),
            data, {"cache_build": (12 * cache_chunks(data), 0),
                   "train": (0, 0), "eval": (0, 0)},
            (f"Frozen-feature cache: {2 * DISTINCT_IMAGES} images",
             "Adaptive token lengths"))
        emit({"phase": "train_vit_epoch", "card": card, "model": model_name,
              "answers": ANSWERS,
              "dtype": "bfloat16 compute, fp32 master weights",
              "dropout": "production (T5 0.1, fusing layer 0.5)",
              "batch": BATCH, "train_steps": TRAIN_BATCHES,
              "eval_forwards": TEST_BATCHES, **epoch})

        raws = raw_batches(torch, cfg, data, "vit", BF16_STEPS)
        cache, cached = cache_parity(
            torch, cfg, lambda: _build_vit_model(torch, torch.float32, True,
                                                 dropout=False), data, raws)
        emit({"phase": "train_vit_cache", "card": card, "model": model_name,
              **cache})
        batches = [_device_batch(r) for r in raws]
        parity = train_parity(
            torch, cfg, batches,
            lambda flag: _build_vit_model(torch, torch.float32, flag,
                                          dropout=False), (12, 0))
        fine_tuned = fine_tuned_steps(torch, cfg, batches)
        emit({"phase": "train_vit_parity", "card": card, "model": model_name,
              **parity, "fine_tuned": fine_tuned})

        # the reloaded best model (production dropout) takes the cached
        # batch
        variants = {
            "cached": (reloaded, cached[0]),
            "cache_off": (prepare_model(
                _build_vit_model(torch, torch.float32, True),
                torch.device(DEVICE), torch.bfloat16).train(), batches[0]),
            "fine_tuned": (prepare_model(
                _build_vit_model(torch, torch.float32, True,
                                 fine_tune_vision=True),
                torch.device(DEVICE), torch.bfloat16).train(), batches[0])}
        timing = train_timing(torch, cfg, variants, card, "train_vit_timing",
                              True, TRAIN_ROUNDS)
        del variants, reloaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    per_step = {}
    for name in ("attention", "bottleneck"):
        per_step[name] = {
            "cache_build": epoch["launches_cache_build"][name],
            "eval_forward_cached": epoch["launches_per_eval_forward"][name],
            **{label: timing[label]["launches_per_step"][name]
               for label in ("cached", "cache_off", "fine_tuned")}}
    emit({"phase": "train_vit", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return {"epoch": epoch["launches"], "per_step": per_step}


def phase_train_family(torch, card, family):
    """The Faster-RCNN (``frcnn``) or cross-attention (``cross``) family's
    training path at full width (see the module docstring). Returns the
    launch counts of the epoch and per step."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.train.trainer import _device_batch, prepare_model

    spec = FAMILIES[family]
    build = lambda flag=True, dropout=True: spec["build"](
        torch, torch.float32, flag, dropout=dropout)
    t_phase = time.perf_counter()
    data = train_data(TRAIN_BATCHES, TEST_BATCHES, spec["size"])
    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_train_{family}_")
    try:
        cfg = train_config(out_dir, spec["vision"], spec["lang"])
        if family == "frcnn":     # the cache holds the FPN's pool level
            expect = {"cache_build": (0, 7 * cache_chunks(data)),
                      "train": (0, 0), "eval": (6, 0)}
            log_lines = (f"Frozen-feature cache: {2 * DISTINCT_IMAGES} "
                         f"images",)
        else:                     # no cache; RoBERTa has no attention dropout
            expect = {"cache_build": (0, 0), "train": (24, 0),
                      "eval": (24, 0)}
            log_lines = ("Frozen-feature cache: off (CrossAttentionVitVQA"
                         "Model has no separable frozen tower)",)
        v0 = A.vjps
        reloaded, epoch = train_epoch(torch, cfg, build, data, expect,
                                      log_lines)
        epoch["attention_vjps"] = A.vjps - v0
        want_vjps = 12 * TRAIN_BATCHES if family == "cross" else 0
        if epoch["attention_vjps"] != want_vjps:
            raise AssertionError(f"{family} epoch: {epoch['attention_vjps']}"
                                 f" attention VJPs, expected {want_vjps}")
        emit({"phase": f"train_{family}_epoch", "card": card,
              "model": spec["model"], "answers": ANSWERS,
              "dtype": "bfloat16 compute, fp32 master weights",
              "dropout": "production", "batch": BATCH,
              "train_steps": TRAIN_BATCHES, "eval_forwards": TEST_BATCHES,
              **epoch})

        raws = raw_batches(torch, cfg, data, spec["session"], BF16_STEPS)
        batches = [_device_batch(r) for r in raws]
        variants = {}
        if family == "frcnn":
            cache, cached = cache_parity(
                torch, cfg, lambda: build(dropout=False), data, raws)
            emit({"phase": f"train_{family}_cache", "card": card,
                  "model": spec["model"], **cache})
            variants["cached"] = (reloaded, cached[0])
            variants["cache_off"] = (prepare_model(
                build(), torch.device(DEVICE), torch.bfloat16).train(),
                batches[0])
        else:
            variants["production"] = (reloaded, batches[0])
        parity = train_parity(torch, cfg, batches,
                              lambda flag: build(flag, dropout=False),
                              spec["launches"])
        emit({"phase": f"train_{family}_parity", "card": card,
              "model": spec["model"], **parity})
        timing = train_timing(torch, cfg, variants, card,
                              f"train_{family}_timing", True,
                              FAMILY_TRAIN_ROUNDS)
        del variants, reloaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    per_step = {}
    for name in ("attention", "bottleneck"):
        per_step[name] = {
            "cache_build": epoch["launches_cache_build"][name],
            "production_step": epoch["launches_per_train_step"][name],
            "eval_forward": epoch["launches_per_eval_forward"][name],
            "dropout_0_cache_off": dict(zip(
                ("attention", "bottleneck"),
                parity["bfloat16"]["launches_per_step_on"]))[name],
            **{label: timing[label]["launches_per_step"][name]
               for label in timing}}
    per_step["attention"]["vjps_per_production_step"] = \
        epoch["attention_vjps"] // TRAIN_BATCHES
    emit({"phase": f"train_{family}", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return {"epoch": epoch["launches"], "per_step": per_step}


def _steps(torch, cfg, model, dtype, batches, total):
    """Run ``batches`` through the port's train step (the trainer's
    optimizer over ``total`` steps): losses and launches per step."""
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import build_optimizer, make_train_step

    optimizer, scheduler, _, trainable = build_optimizer(
        model, cfg.optimizer, cfg.lr_scheduler, total,
        frozen_modules=model.frozen_modules())
    step = make_train_step(model, optimizer, scheduler, trainable,
                           cfg.trainer.gradient_clipping, dtype)
    losses, counts = [], []
    for batch in batches:
        a0, k0 = A.launches, K.launches
        losses.append(float(step(batch)[0]))
        counts.append((A.launches - a0, K.launches - k0))
    return losses, counts


def train_parity(torch, cfg, batches, build, on_counts_expected,
                 after_bf16=None):
    """Kernels on against off at dropout 0, same weights and batches (images,
    the cache off): bf16 over BF16_STEPS batches, fp32 (no TF32) over one
    batch repeated FP32_STEPS times, whose loss must fall. ``build(flag)``
    builds the fp32 model with the kernels on or off; ``on_counts_expected``
    is the (attention, bottleneck) launches of a step with them on;
    ``after_bf16`` is called with the bf16 pair after its comparison."""
    from t5_resnet_vqa_torch.train.trainer import prepare_model

    cfg = parity_config(cfg)
    out = {"bf16_steps": BF16_STEPS, "fp32_steps": FP32_STEPS,
           "lrs": PARITY_LRS}
    for dtype_name, n in (("bfloat16", BF16_STEPS), ("float32", FP32_STEPS)):
        dtype = getattr(torch, dtype_name)
        models = {flag: prepare_model(build(flag), torch.device(DEVICE),
                                      dtype).train() for flag in (True, False)}
        run = batches if dtype_name == "bfloat16" else [batches[0]] * n
        before = {k: v.detach().clone() for k, v in
                  models[True].named_parameters()}
        res = {flag: _steps(torch, cfg, m, dtype, run, n)
               for flag, m in models.items()}
        (on, on_counts), (off, off_counts) = res[True], res[False]
        if on_counts != [on_counts_expected] * n or off_counts != [(0, 0)] * n:
            raise AssertionError(f"{dtype_name} launches per step: kernels "
                                 f"on {on_counts}, off {off_counts}")
        if not all(np.isfinite(on + off)):
            raise AssertionError(f"{dtype_name} losses {on} / {off}")
        tol = TRAIN_LOSS_TOL[dtype_name]
        diffs = [abs(a - b) if dtype_name == "bfloat16"
                 else abs(a - b) / abs(b) for a, b in zip(on, off)]
        if not max(diffs) <= tol:
            raise AssertionError(f"{dtype_name} losses on {on} off {off}: "
                                 f"differ by {max(diffs)} > {tol}")
        line = {"losses_on": on, "losses_off": off,
                "loss_diff": max(diffs), "loss_tol": tol,
                "launches_per_step_on": on_counts[0]}
        if dtype_name == "float32":
            if not on[-1] < on[0]:
                raise AssertionError(f"the loss on a repeated batch did not "
                                     f"fall: {on}")
            off_params = dict(models[False].named_parameters())
            num = den = 0.0
            max_diff = 0.0
            for name, p in models[True].named_parameters():
                d = (p.detach() - off_params[name].detach()).double()
                u = (p.detach() - before[name]).double()
                num += float((d * d).sum())
                den += float((u * u).sum())
                max_diff = max(max_diff, float(d.abs().max()))
            ratio = (num / den) ** 0.5
            if not ratio <= UPDATE_TOL:
                raise AssertionError(f"fp32 parameters on/off differ by "
                                     f"{ratio} of their update > "
                                     f"{UPDATE_TOL}")
            line.update({"update_diff_over_update": ratio,
                         "update_tol": UPDATE_TOL,
                         "param_max_abs_diff": max_diff})
        elif after_bf16 is not None:
            after_bf16(models)
        out[dtype_name] = line
        del models, res, before
        torch.cuda.empty_cache()
    return out


def fine_tuned_steps(torch, cfg, batches):
    """FINE_TUNED_STEPS steps of a fine-tuned ViT tower (bf16 compute, fp32
    master weights, dropout 0) with the kernels on and off, same weights
    and batches: 12 kernel forwards per step with them on, whose backward
    is the plain version's VJP; every tower parameter moves; bf16 losses
    within TRAIN_LOSS_TOL."""
    from t5_resnet_vqa_torch.train.trainer import prepare_model

    cfg = parity_config(cfg)
    n = FINE_TUNED_STEPS
    models = {flag: prepare_model(
        _build_vit_model(torch, torch.float32, flag, dropout=False,
                         fine_tune_vision=True),
        torch.device(DEVICE), torch.bfloat16).train()
        for flag in (True, False)}
    tower = {k: v.detach().clone() for k, v in
             models[True].vision_model.named_parameters()}
    res = {flag: _steps(torch, cfg, m, torch.bfloat16, batches[:n], n)
           for flag, m in models.items()}
    (on, on_counts), (off, off_counts) = res[True], res[False]
    if on_counts != [(12, 0)] * n or off_counts != [(0, 0)] * n:
        raise AssertionError(f"fine-tuned launches per step: kernels on "
                             f"{on_counts}, off {off_counts}")
    diff = max(abs(a - b) for a, b in zip(on, off))
    if not (np.isfinite(on + off).all()
            and diff <= TRAIN_LOSS_TOL["bfloat16"]):
        raise AssertionError(f"fine-tuned losses on {on} off {off}")
    if models[True].vision_model.embeddings.cls_token.dtype != torch.float32:
        raise AssertionError("the fine-tuned tower lost its fp32 master "
                             "weights")
    still = [k for k, p in models[True].vision_model.named_parameters()
             if torch.equal(p.detach(), tower[k])]
    if still:
        raise AssertionError(f"fine-tuned tower parameters that did not "
                             f"train: {still[:5]} (of {len(still)})")
    del models, tower
    torch.cuda.empty_cache()
    return {"steps": n, "losses_on": on, "losses_off": off,
            "loss_diff": diff, "launches_per_step_on": on_counts[0],
            "lrs": {**PARITY_LRS, "vision_lr": cfg.optimizer.vision_lr}}


def train_timing(torch, cfg, variants, card, phase, dropout,
                 rounds=TRAIN_ROUNDS):
    """Median train-step ms of each variant (``{label: (model, batch)}``) in
    turns (CUDA events; each step ends in a synchronisation that reads the
    loss), its kernels' launches per step, and each one's device busy ms
    and kernel launches per step (the vision tower where the batch has
    images, the text encoder, the forward, the whole step; backward +
    optimizer = step - forward) and the device's idle share over
    TRAIN_WINDOW profiled steps. bf16 compute; ``dropout`` says whether the
    rates are the production ones."""
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import build_optimizer, make_train_step

    steps = {}
    for label, (model, batch) in variants.items():
        optimizer, scheduler, _, trainable = build_optimizer(
            model, cfg.optimizer, cfg.lr_scheduler, 10000,
            frozen_modules=model.frozen_modules())
        step = make_train_step(model, optimizer, scheduler, trainable,
                               cfg.trainer.gradient_clipping, torch.bfloat16)
        steps[label] = lambda step=step, batch=batch: float(step(batch)[0])
        for _ in range(3):
            steps[label]()
    labels = list(variants)
    times = {label: [] for label in labels}
    for r in range(rounds):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            times[label].append(step_ms(torch, steps[label]))
    result = {}
    for label, (model, batch) in variants.items():
        a0, k0, v0 = A.launches, K.launches, A.vjps
        steps[label]()
        counts = {"attention": A.launches - a0, "bottleneck": K.launches - k0,
                  "attention_vjps": A.vjps - v0}
        median = float(np.median(times[label]))
        line = {"phase": phase, "config": label, "card": card,
                "dropout": "production" if dropout else 0.0,
                "dtype": "bfloat16", "batch": BATCH,
                "train_step_ms": median,
                "train_samples_per_s": BATCH / (median / 1e3),
                "fastest_step_ms": float(min(times[label])),
                "launches_per_step": counts, "steps_ms": times[label]}
        line.update(train_breakdown(torch, model, batch, steps[label]))
        emit(line)
        result[label] = {k: v for k, v in line.items() if k != "steps_ms"}
    return result


def step_ms(torch, fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def train_breakdown(torch, model, batch, step):
    """Device busy ms and launches of a train step's parts (one call each;
    the step's own as the mean over TRAIN_WINDOW profiled steps), and the
    idle share over those steps (the profiler's host work included)."""
    autocast = lambda: torch.autocast(DEVICE, dtype=torch.bfloat16)
    images = batch.get("image_tensors", batch.get("pixel_values"))
    # the ViT family's text encoder sits in its T5ForConditionalGeneration;
    # the cross-attention family has neither a separable tower nor a T5
    encoder = (model.lang_model.encoder if hasattr(model, "decode_hidden")
               else getattr(model, "lang_model", None))
    parts = {}
    if images is not None and hasattr(model, "compute_vision_features"):
        def vision():
            with torch.no_grad(), autocast():
                model.compute_vision_features(images)
        parts["vision"] = vision

    def text():
        with autocast():
            encoder(batch["question_input_ids"],
                    batch["question_attention_masks"])

    def forward():
        with autocast():
            model(**batch)

    if encoder is not None:
        parts["text"] = text
    parts["forward"] = forward
    device = {name: profile_device(torch, fn, iters=1)
              for name, fn in parts.items()}
    # the step's numbers are per step of the window (the profiler's
    # bookkeeping of a window costs seconds; one window serves both)
    window = profile_device(torch, step, iters=TRAIN_WINDOW)
    device["step"] = window
    busy = {k: v["busy_ms"] for k, v in device.items()}
    busy["backward_optimizer"] = busy["step"] - busy["forward"]
    count = {k: v["launches"] for k, v in device.items()}
    count["backward_optimizer"] = count["step"] - count["forward"]
    return {"device_busy_ms": busy, "kernel_launches": count,
            "device_idle_share": 1.0 - window["busy_ms"] / window["elapsed_ms"],
            "idle_window": {"steps": TRAIN_WINDOW,
                            "busy_ms": window["busy_ms"],
                            "elapsed_ms": window["elapsed_ms"]},
            "top_kernels": [{"us": us / TRAIN_WINDOW,
                             "calls": n / TRAIN_WINDOW, "name": name}
                            for us, n, name in window["kernels"][:12]]}


# --------------------------------------------------------- checkpoint phases

RESUME_EVERY = 3       # the child's checkpoint_every_steps
# the resumed run's dropout-0 step against the uninterrupted run's: both
# start from the state of step 3 (restored from the pair, or reached by
# running on), with the same kernels, batch and order, so a larger gap
# means that the restored state differs
RESUME_TOL = 1e-6
RESUME_CHILD_S = 300   # the child's time limit
BG_ROUNDS = 2          # step timings with and without a save in flight
SERVE_CKPT_STEPS = 2
# served log-probs against the trainer's eval step on the same weights
# and requests: both run the same bf16 forward, so they should agree to the
# bit; 1e-3 allows for another order of the same sums
SERVED_TOL = 1e-3
# per family: the (attention, bottleneck) launches of a served forward and
# the model
SERVED_LAUNCHES = {
    "cnn": ((6, 7), "resnet50 + t5-base + 3xSGA"),
    "vit": ((12, 0), "vit-base + t5-base enc-dec"),
    **{f: (spec["launches"], spec["model"]) for f, spec in FAMILIES.items()},
}


def resume_setup(torch, family, out_dir):
    """(config, model builder, data) of the resume phase: the reference
    config at full width, B=64, bf16 compute; the CNN family with the cache
    off (the bottleneck kernel runs in every step), the ViT family with it
    on (the production setting). Also the Faster-RCNN and cross-attention
    families' (``FAMILIES``), which serve from a checkpoint."""
    if family in FAMILIES:            # serving from a checkpoint only
        spec = FAMILIES[family]
        data = train_data(TRAIN_BATCHES, TEST_BATCHES, spec["size"])
        cfg = train_config(out_dir, spec["vision"], spec["lang"])
        return cfg, lambda: spec["build"](torch, torch.float32, True), data
    size = IMAGE if family == "cnn" else VIT_IMAGE
    data = train_data(TRAIN_BATCHES, TEST_BATCHES, size)
    if family == "cnn":
        cfg = train_config(out_dir)
        cfg.trainer.cache_frozen_features = False
        build = lambda: _build_model(torch, torch.float32, True)
    else:
        cfg = train_config(out_dir, VIT_NAME)
        build = lambda: _build_vit_model(torch, torch.float32, True)
    return cfg, build, data


def deterministic(torch):
    """cuDNN's deterministic algorithms: the child and the reference run
    must take the same first steps to the bit."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resume_child(family, out_dir) -> int:
    """The crashed run: trains with ``checkpoint_every_steps=3`` and
    SIGKILLs itself when its second pair is about to write the state
    ``.next``, after the params ``.next`` has landed (the worst crash
    window)."""
    import signal

    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic(torch)
    from t5_resnet_vqa_torch.train import VQATrainer
    from t5_resnet_vqa_torch.train.callbacks import CheckpointManager

    cfg, build, data = resume_setup(torch, family, out_dir)
    cfg.trainer.checkpoint_every_steps = RESUME_EVERY
    answers, train_ds, test_ds, load_images = data
    real = CheckpointManager._save_file
    state_writes = []

    def save_file(self, path, tree):
        if path.endswith("state_dict_checkpoint.pt.next"):
            state_writes.append(path)
            if len(state_writes) == 2:
                os.kill(os.getpid(), signal.SIGKILL)
        real(self, path, tree)

    CheckpointManager._save_file = save_file
    with seeded_images(load_images):
        VQATrainer(build(), cfg, answers, train_ds, test_ds).train()
    print("the child was not killed", file=sys.stderr)
    return 3


def trainable(trainer):
    return [p for g in trainer.optimizer.param_groups for p in g["params"]]


def fixed_step(torch, trainer, batch):
    """One step of ``trainer`` at dropout 0 (the model in eval mode) on
    ``batch``: (loss, the trainable parameters' update)."""
    params = trainable(trainer)
    before = [p.detach().clone() for p in params]
    trainer.model.eval()
    loss = float(trainer.train_step(batch)[0])
    trainer.model.train()
    return loss, [p.detach() - b for p, b in zip(params, before)]


def first_batch(torch, loader):
    from t5_resnet_vqa_torch.data import to_device
    from t5_resnet_vqa_torch.train.trainer import _device_batch

    return _device_batch(to_device(next(iter(loader)), torch.device(DEVICE)))


def tree_equal(torch, got, want) -> bool:
    """Every tensor of ``got`` (the card) equals ``want`` (a file) to the
    bit, on the device of ``got``; a bf16 tensor equals its fp32 file
    value widened."""
    if isinstance(want, torch.Tensor):
        return torch.equal(got.float() if got.is_floating_point() else got,
                           want.to(got.device).to(
                               torch.float32 if got.is_floating_point()
                               else got.dtype))
    if isinstance(want, dict):
        return set(got) == set(want) and all(
            tree_equal(torch, got[k], want[k]) for k in want)
    return got == want


def resume_family(torch, card, family):
    import shutil
    import signal
    import tempfile

    from t5_resnet_vqa_torch.data import Prefetcher
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import VQATrainer
    from t5_resnet_vqa_torch.train.callbacks import checkpoint_state_dict
    from t5_resnet_vqa_torch.train.trainer import _device_batch

    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix=f"chip_smoke_resume_{family}_")
    try:
        run_dir = os.path.join(out, "run")
        ck = os.path.join(run_dir, "model_checkpoints")
        t0 = time.perf_counter()
        with open(os.path.join(out, "child.log"), "w") as log:
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--resume-child",
                 family, run_dir], stdout=log, stderr=subprocess.STDOUT,
                timeout=RESUME_CHILD_S)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            with open(os.path.join(out, "child.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"the {family} child exited with "
                                 f"{child.returncode}, not SIGKILL:\n{tail}")
        after_kill = sorted(f for f in os.listdir(ck) if f.endswith(
            (".pt", ".next")))
        params_next = os.path.join(ck, "checkpoint-model.pt.next")
        if after_kill != ["checkpoint-model.pt", "checkpoint-model.pt.next",
                          "state_dict_checkpoint.pt"]:
            raise AssertionError(f"after the kill: {after_kill}")
        pair_bytes = sum(os.path.getsize(os.path.join(ck, f)) for f in
                         ("checkpoint-model.pt", "state_dict_checkpoint.pt"))

        # the uninterrupted run: the same 3 steps, then a dropout-0 step on
        # a fixed batch
        deterministic(torch)
        cfg, build, data = resume_setup(torch, family,
                                        os.path.join(out, "reference"))
        answers, train_ds, test_ds, load_images = data
        with seeded_images(load_images):
            ref = VQATrainer(build(), cfg, answers, train_ds, test_ds)
            ref.model.train()
            for raw, _ in zip(Prefetcher(ref.train_dataloader,
                                         ref.num_prefetch, ref.device),
                              range(RESUME_EVERY)):
                ref.train_step(_device_batch(raw))
            fixed = first_batch(torch, ref.test_dataloader)
        pair_params = torch.load(os.path.join(ck, "checkpoint-model.pt"),
                                 map_location="cpu", weights_only=True)
        reference_diff = max(
            float((v.float() - pair_params[k].to(v.device)).abs().max())
            for k, v in ref.model.state_dict().items()
            if v.is_floating_point())
        ref_loss, ref_update = fixed_step(torch, ref, fixed)
        del ref
        torch.cuda.empty_cache()

        # the resumed run, its resume timed and its launches counted
        cfg, build, data = resume_setup(torch, family, run_dir)
        cfg.trainer.load_from_checkpoint = True
        original = VQATrainer._try_resume
        resume_s = []

        def timed_resume(self):
            t = time.perf_counter()
            original(self)
            torch.cuda.synchronize()
            resume_s.append(time.perf_counter() - t)

        VQATrainer._try_resume = timed_resume
        A.launches = 0
        K.launches = 0
        try:
            with seeded_images(load_images):
                res = VQATrainer(build(), cfg, answers, train_ds, test_ds)
        finally:
            VQATrainer._try_resume = original
        rebuild = {"attention": A.launches, "bottleneck": K.launches}
        if os.path.exists(params_next):
            raise AssertionError("the lone params .next survived the resume")
        if (res.start_epoch, res.global_step) != (0, RESUME_EVERY):
            raise AssertionError(f"resumed at epoch {res.start_epoch}, step "
                                 f"{res.global_step}: not the first pair")
        state = torch.load(os.path.join(ck, "state_dict_checkpoint.pt"),
                           map_location="cpu", weights_only=True)
        model_equal = tree_equal(torch, res.model.state_dict(), pair_params)
        moments = res.optimizer.state_dict()["state"]
        optimizer_equal = tree_equal(torch, moments,
                                     state["optimizer"]["state"])
        on_card = all(v.is_cuda for m in moments.values()
                      for k, v in m.items() if k != "step")
        lrs = {g["group"]: g["lr"] for g in res.optimizer.param_groups}
        lr_equal = all(lr == res._schedules[g](RESUME_EVERY)
                       for g, lr in lrs.items())
        if not (model_equal and optimizer_equal and on_card and lr_equal):
            raise AssertionError(
                f"restored state: model equal {model_equal}, optimizer "
                f"equal {optimizer_equal}, on the card {on_card}, LRs at "
                f"the schedule's step {RESUME_EVERY} {lr_equal}")
        del pair_params, state

        res_loss, res_update = fixed_step(torch, res, fixed)
        loss_diff = abs(res_loss - ref_loss) / abs(ref_loss)
        num = sum(float(((a - b).double() ** 2).sum())
                  for a, b in zip(res_update, ref_update))
        den = sum(float((b.double() ** 2).sum()) for b in ref_update)
        update_diff = (num / den) ** 0.5
        del ref_update, res_update
        if not (loss_diff <= RESUME_TOL and update_diff <= RESUME_TOL):
            raise AssertionError(
                f"the resumed dropout-0 step: loss {res_loss} against "
                f"{ref_loss} ({loss_diff} relative), update {update_diff} "
                f"relative (L2); tolerance {RESUME_TOL}")

        # one production step of the resumed run, its launches counted
        res.model.train()
        with seeded_images(load_images):
            batch = first_batch(torch, res.train_dataloader)
        A.launches = 0
        K.launches = 0
        res.train_step(batch)
        torch.cuda.synchronize()
        per_step = {"attention": A.launches, "bottleneck": K.launches}
        want_step = {"attention": 0,
                     "bottleneck": 7 if family == "cnn" else 0}
        want_rebuild = {"attention": 0 if family == "cnn"
                        else 12 * cache_chunks(data), "bottleneck": 0}
        if per_step != want_step or rebuild != want_rebuild:
            raise AssertionError(f"launches per resumed step {per_step} "
                                 f"(expected {want_step}), cache rebuild "
                                 f"{rebuild} (expected {want_rebuild})")

        # a synchronous pair save, then steps with and without a
        # background pair save in flight, in turns
        t = time.perf_counter()
        res.callbacks.ckpt.save_pair(
            checkpoint_state_dict(res.model),
            {"epoch": 0, "global_step": res.global_step,
             "optimizer": res.optimizer.state_dict(),
             "scheduler": res.scheduler.state_dict()})
        pair_save_s = time.perf_counter() - t
        step = lambda: float(res.train_step(batch)[0])
        step()
        times = {"no_save": [], "save_in_flight": []}
        submit_ms, land_s = [], []
        for r in range(BG_ROUNDS):
            for label in (("no_save", "save_in_flight") if r % 2 == 0
                          else ("save_in_flight", "no_save")):
                if label == "no_save":
                    times[label].append(step_ms(torch, step))
                    continue
                t = time.perf_counter()
                res.callbacks.save_epoch_checkpoint(
                    res.model, 0, res.optimizer, res.scheduler,
                    res.global_step)
                torch.cuda.synchronize()
                submit_ms.append((time.perf_counter() - t) * 1e3)
                times[label].append(step_ms(torch, step))
                res.callbacks.ckpt.flush()
                land_s.append(time.perf_counter() - t)
        line = {"phase": "resume", "family": family, "card": card,
                "model": ("resnet50 + t5-base + 3xSGA" if family == "cnn"
                          else "vit-base + t5-base enc-dec"),
                "cache": "off" if family == "cnn" else "on",
                "batch": BATCH, "dtype": "bfloat16 compute, fp32 master "
                "weights", "checkpoint_every_steps": RESUME_EVERY,
                "child": {"exit": "SIGKILL", "seconds": child_s,
                          "killed": "after the params .next of pair 2, "
                                    "before its state .next"},
                "files_after_kill": after_kill,
                "lone_params_next_discarded": True,
                "adopted_pair": {"epoch": res.start_epoch,
                                 "global_step": res.global_step},
                "state_bit_equal": {"model": model_equal,
                                    "optimizer": optimizer_equal,
                                    "optimizer_on_card": on_card},
                "lrs_equal_schedule_at_step": RESUME_EVERY,
                "reference_state_max_abs_diff_from_pair": reference_diff,
                "fixed_step": {"loss_reference": ref_loss,
                               "loss_resumed": res_loss,
                               "loss_rel_diff": loss_diff,
                               "update_rel_l2_diff": update_diff,
                               "tol": RESUME_TOL},
                "launches_cache_rebuild": rebuild,
                "launches_per_resumed_step": per_step,
                "pair_bytes": pair_bytes, "pair_save_s": pair_save_s,
                "resume_s": resume_s[0],
                "background_save_step_ms": {
                    k: float(np.median(v)) for k, v in times.items()},
                "background_save": {"rounds": BG_ROUNDS,
                                    "steps_ms": times,
                                    "submit_ms": submit_ms,
                                    "submit_to_landed_s": land_s}}
        del res, step, batch, fixed
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(out, ignore_errors=True)
    line["seconds"] = time.perf_counter() - t_phase
    return line


def trace_epoch(torch, card):
    """One CNN epoch (2 steps, dropout 0, the cache off: both kernels run
    in its steps) with ``trace_dir`` set: the trace must name both
    kernels."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.train import VQATrainer

    out = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        answers, train_ds, test_ds, load_images = train_data(2, 1)
        cfg = train_config(os.path.join(out, "run"))
        cfg.trainer.cache_frozen_features = False
        cfg.trainer.monitor_test = False
        cfg.trainer.trace_dir = os.path.join(out, "trace")
        t0 = time.perf_counter()
        with seeded_images(load_images):
            VQATrainer(_build_model(torch, torch.float32, True,
                                    dropout=False),
                       cfg, answers, train_ds, test_ds).train()
        epoch_s = time.perf_counter() - t0
        files = os.listdir(cfg.trainer.trace_dir)
        if len(files) != 1:
            raise AssertionError(f"trace_dir holds {files}")
        path = os.path.join(cfg.trainer.trace_dir, files[0])
        with open(path) as f:
            text = f.read()
        names = {k: k in text for k in ("attention_bf16", "bottleneck_bf16")}
        if not all(names.values()):
            raise AssertionError(f"the trace names the kernels: {names}")
        return {"file": files[0], "bytes": os.path.getsize(path),
                "names_kernels": names, "epoch_s": epoch_s}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_resume(torch, card):
    """Kill-and-resume of both families (see the module docstring), and
    the ``trace_dir`` epoch. Returns the launch counts."""
    lines = {family: resume_family(torch, card, family)
             for family in ("cnn", "vit")}
    lines["cnn"]["trace_dir"] = trace_epoch(torch, card)
    for line in lines.values():
        emit(line)
    return {name: {family: {"cache_rebuild": line["launches_cache_rebuild"][
        name], "per_resumed_step": line["launches_per_resumed_step"][name]}
        for family, line in lines.items()}
        for name in ("attention", "bottleneck")}


def serve_from_checkpoint_family(torch, card, family):
    """Train 2 steps, write ``best-model.pt`` through the callbacks, serve
    it with ``VQAInferenceSession.from_checkpoint`` and hold ``ask_batch``
    on 64 requests against the trainer's eval step on the same requests."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.data import Annotation, Question, Sample
    from t5_resnet_vqa_torch.data import Prefetcher, to_device
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import VQATrainer
    from t5_resnet_vqa_torch.train.trainer import _device_batch

    out = tempfile.mkdtemp(prefix=f"chip_smoke_serve_ckpt_{family}_")
    try:
        cfg, build, data = resume_setup(torch, family, out)
        cfg.trainer.cache_frozen_features = False
        answers, train_ds, test_ds, load_images = data
        requests = [(s.image_path, s.question.question_text)
                    for s in test_ds[:BATCH]]
        with seeded_images(load_images):
            trainer = VQATrainer(build(), cfg, answers, train_ds, test_ds)
            trainer.model.train()
            for raw, _ in zip(Prefetcher(trainer.train_dataloader,
                                         trainer.num_prefetch,
                                         trainer.device),
                              range(SERVE_CKPT_STEPS)):
                trainer.train_step(_device_batch(raw))
            trainer.callbacks.save_checkpoint(trainer.model, 0, answers)
            trainer.callbacks.ckpt.flush()
            samples = [Sample(Question(q, f"req_{i}", f"req_{i}"),
                              Annotation(f"req_{i}", f"req_{i}",
                                         [answers[0]]), img)
                       for i, (img, q) in enumerate(requests)]
            trimmed = _device_batch(to_device(
                trainer.test_dataloader.collate_fn(samples),
                torch.device(DEVICE)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session = VQAInferenceSession.from_checkpoint(cfg,
                                                          batch_size=BATCH)
            torch.cuda.synchronize()
            from_checkpoint_s = time.perf_counter() - t0
            A.launches = 0
            K.launches = 0
            results = session.ask_batch(requests, top_k=ANSWERS)
            launches = {"attention": A.launches, "bottleneck": K.launches}
            # the trainer's eval step on the requests as the session
            # collates them, and as validation does: the ViT trainer trims
            # trailing pad columns (adaptive_question_len), the session keeps
            # the full lengths, as the JAX session does
            full = session._to_device(session._collate_chunk(requests))
            trainer.model.eval()
            with torch.inference_mode(), torch.autocast(
                    DEVICE, dtype=torch.bfloat16):
                want, want_trimmed = (trainer.model(**b)[0].float().cpu()
                                      .numpy() for b in (full, trimmed))
        del trainer, full, trimmed
        got = np.full_like(want, -np.inf)
        index = {a: i for i, a in enumerate(answers)}
        for row, r in zip(got, results):
            for a, p in zip(r["top_answers"], r["top_probs"]):
                row[index[a]] = np.log(p)
        diff = float(np.abs(got - want).max())
        top1_equal = bool((got.argmax(-1) == want.argmax(-1)).all())
        trimmed_diff = float(np.abs(got - want_trimmed).max())
        trimmed_top1 = float((got.argmax(-1) == want_trimmed.argmax(-1))
                             .mean())
        want_launches = dict(zip(("attention", "bottleneck"),
                                 SERVED_LAUNCHES[family][0]))
        if launches != want_launches:
            raise AssertionError(f"served launches {launches}, expected "
                                 f"{want_launches}")
        if not (diff <= SERVED_TOL and top1_equal):
            raise AssertionError(f"served log-probs {diff} from the "
                                 f"trainer's eval (tolerance {SERVED_TOL}),"
                                 f" top-1 equal {top1_equal}")
        del session
        torch.cuda.empty_cache()
        return {"phase": "serve_from_checkpoint", "family": family,
                "card": card, "model": SERVED_LAUNCHES[family][1],
                "train_steps": SERVE_CKPT_STEPS, "requests": len(requests),
                "dtype": "bfloat16 compute, fp32 weights",
                "from_checkpoint_s": from_checkpoint_s,
                "logprob_max_abs_diff": diff, "tol": SERVED_TOL,
                "top1_equal": top1_equal,
                "trimmed_validation_batch": {
                    "logprob_max_abs_diff": trimmed_diff,
                    "top1_agreement": trimmed_top1},
                "launches": launches}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_serve_from_checkpoint(torch, card):
    lines = {f: serve_from_checkpoint_family(torch, card, f)
             for f in SERVED_LAUNCHES}
    for line in lines.values():
        emit(line)
    return {name: {f: line["launches"][name] for f, line in lines.items()}
            for name in ("attention", "bottleneck")}


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--resume-child"]:
        return resume_child(*sys.argv[2:4])
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
    vit_launches = phase_serve_vit(torch, card)
    family_launches = {f: phase_serve_family(torch, card, f)
                       for f in FAMILIES}
    train = phase_train(torch, card)
    train_vit = phase_train_vit(torch, card)
    family_train = {f: phase_train_family(torch, card, f) for f in FAMILIES}
    resumed = phase_resume(torch, card)
    served = phase_serve_from_checkpoint(torch, card)

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
                        "bound_share": numbers["bound_ms"] / numbers["ms"],
                        "bound_by": numbers["bound_by"],
                        "library_ms": numbers["library_ms"],
                        "train_epoch_launches": train["epoch"][name],
                        "train_launches_per_step": train["per_step"][name],
                        "vit_train_epoch_launches": train_vit["epoch"][name],
                        "vit_train_launches_per_step":
                            train_vit["per_step"][name],
                        "resume_launches": resumed[name],
                        "serve_from_checkpoint_launches": served[name]})
        for f in FAMILIES:
            kernels[-1].update({
                f"{f}_launches": family_launches[f][name],
                f"{f}_train_epoch_launches": family_train[f]["epoch"][name],
                f"{f}_train_launches_per_step":
                    family_train[f]["per_step"][name]})
    vit, cross = att["vit"], att["cross"]
    kernels[0].update({f"cross_{k}": v for k, v in cross.items()})
    kernels[0].update({"bwd_ms": att["bwd_ms"],
                       "plain_bwd_ms": att["plain_bwd_ms"],
                       "bwd_max_abs_err": att["bwd_max_abs_err"],
                       "vit_launches": vit_launches["attention"],
                       "vit_ms": vit["ms"],
                       "vit_ms_head_views": vit["ms_head_views"],
                       "vit_plain_ms": vit["plain_ms"],
                       "vit_bound_ms": vit["bound_ms"],
                       "vit_bound_by": vit["bound_by"],
                       "vit_library_ms": vit["library_ms"],
                       "vit_max_abs_err": vit["max_abs_err"],
                       "vit_bwd_ms": vit["bwd_ms"],
                       "vit_plain_bwd_ms": vit["plain_bwd_ms"],
                       "vit_bwd_max_abs_err": vit["bwd_max_abs_err"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
