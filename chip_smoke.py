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
              bf16, and time kernel, plain version and (for attention)
              PyTorch's ``scaled_dot_product_attention`` (for the
              bottleneck, the unfused modules, and the block as a chain of
              cuDNN calls on the folded weights, ``library_chain_ms``,
              timed in bf16 in turns with the kernel: kernel, chain, chain,
              kernel) as device time from the profiler. The build line
              gives ptxas's registers, spills and serialization warnings of
              every bf16 bottleneck instantiation (``bottleneck_ptxas``)
              and of every short_kv attention instantiation
              (``attention_short_ptxas``, by D and key tiles), and of the
              attention backward kernel's and the wgmma forward's by N
              (``attention_bwd_ptxas``, ``attention_tma_ptxas``). On
              the wgmma route the forward that also writes the row
              statistics, as a training step runs it, is timed in turns
              with the serving forward on head views (``stats_fwd_ms``,
              ``no_stats_fwd_ms``).
              Attention is also checked and timed on the head views of
              [B, S, H*D] projections, as the main path hands them over
              (``ms_head_views``); the bottleneck takes the operands its
              module packed once (``Bottleneck.fused``), as on the main
              path, and its line gives the weight bytes the design streams
              from L2 per launch (``weight_stream_mb``, from the shapes).
              The attention backward (``attention_backward``: the kernel
              of ``csrc/attention_bwd.cu`` where the forward takes the
              wgmma route, the plain version's VJP elsewhere) is held
              against autograd of the plain version on head views, with
              the gradient as the main path hands it back, one pass
              counted on its route, at every case (on the kernel's route
              called without the forward's row statistics, so that it
              computes them, counted, and then with them, to the same
              bits); it is timed (``bwd_ms``, given the forward's
              statistics, as the main path gives them) in turns with the
              plain VJP on the kernel's route (plain, kernel, kernel,
              plain: ``plain_vjp_ms``), beside the plain version's own
              backward (``plain_bwd_ms``), SDPA's backward on the same
              views (``library_bwd_ms``; ``bwd_vs_library`` is
              ``bwd_ms / library_bwd_ms``) and its bound
              (``bwd_bound_ms``: q, k, v and the gradient read once, dq,
              dk and dv written once, 5 products); at the ViT shape
              (``vit_bwd_ms``) and the RoBERTa shape (``cross_bwd_ms``)
              among them.
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
              cached, the cache-off and the fine-tuned variants in turns
              (the fine-tuned step's 12 backward passes through the
              backward kernel, none through the plain VJP), and a profile
              of each.
8. train_frcnn, train_cross -- each family at the same width through
              ``VQATrainer`` for one epoch with the reference config
              (production dropout, B=64, bf16 compute with fp32 master
              weights): Faster-RCNN with the cache on (21 bottleneck
              launches build it from the FPN's pool level, 0 per step, 6
              attention per eval forward); cross-attention with the cache
              off and JAX's log line (24 attention launches per step and
              per eval forward, and 12 attention backward passes per step,
              all through the backward kernel, counted from 0 over the
              epoch: the RoBERTa layers train, the frozen ViT's run without
              a gradient). Then
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
11. heatmaps -- the heatmap device step (``viz.heatmap_step``) on one test
              batch of 64 of the CNN and Faster-RCNN sessions of phase 10
              (``cam``: 6 attention + 7 bottleneck launches per forward, the
              Faster-RCNN tower's ``pool`` level alone) and of the ViT one
              (``rollout``: 0 + 0, the tower's plain attention with its
              maps): the top 3 equal ``ask_batch``'s on the same requests
              (the ViT tower on the same plain path), and so do the routing
              by WUPS and the average WUPS; CAMs kernels on against off
              (log-probs within 5e-2; the channel mean within 2e-2 of the
              features' magnitude); the device's rollout mask against
              ``rollout_mask`` on host copies of the same fp32 maps (1e-5);
              device ms and the bytes copied to the host per batch. The
              host step (overlays and PNGs) needs cv2, which the card's
              machine lacks; the CPU tests cover it.
12. http    -- ``VQAHTTPServer`` on an ephemeral port over the CNN and ViT
              sessions of phase 10: /healthz, 64 /v1/ask, one
              /v1/ask_batch of 64, /v1/generate (greedy and 3 beams; a 400
              for the CNN family) and a bad body (400), answers against
              the direct session calls (top-1 equal, probabilities within
              5e-2), 65 forwards' launches exact, requests/s over HTTP
              against the direct call. Empty files stand in for the
              requests' images (no image_b64 decoding).
13. okvqa   -- the CNN family trains one epoch on COCO-style OK-VQA files
              written by the phase (4 train batches and 1 test batch of
              64, the reference config, the cache on: 21 bottleneck
              launches build it, 0 per step, 6 attention per eval
              forward); finite losses, JAX's dataset line, and the labels
              the steps took equal the CPU collate's for the same seed,
              each one of its question's 10 annotator answers.
14. optimizers -- SGD (momentum 0.9), Lamb (weight decay 0.1) and Adafactor
              on phase 13's model and a cached batch, each from the same
              weights: 3 steps at dropout 0 at LR 1e-2 on the repeated
              batch (the loss falls; the card's update within 1e-5, L2,
              of the same optimizer stepped on CPU copies of the same
              parameters, gradients and state); then step times of each
              beside AdamW's, in turns.
15. mesh    -- the (data, model) mesh (``t5_resnet_vqa_torch/parallel``)
              at full width with gloo on CUDA tensors, 4 ranks in processes
              of their own, every one on this card (NCCL refuses two ranks
              on one card): the CNN family (B=64, bf16 compute with fp32
              master weights, dropout 0, AdamW as configured, the cache
              off) takes 3 steps on one device and at dp=2 x tp=1,
              dp=1 x tp=2 and dp=2 x tp=2 (and in fp32 on one device and
              at 2x2): per rank 6 attention launches at H/tp heads and 7
              bottleneck launches at B/dp rows per step, losses and the L2
              of the update within the bf16 train gate (5e-2) and, in fp32,
              1e-4 relative of the one-device run's (and in fp32 the
              parameters within 1e-2 of the update, L2). The steps are set
              up by the trainer's own ``setup_train_step``. At production
              dropout, on one device and at 2x2, the same steps give each
              rank's peak device memory of a step. ``VQATrainer`` itself
              trains one epoch (2 steps, 1 eval batch, dropout 0, the cache
              on) without a mesh and at 2x2 (``mesh=``): every rank
              launches per cache build, step and eval forward what the
              mesh-free trainer does, its cache pinned on the host; losses
              within the bf16 train gate; rank 0 logs the mesh and the
              host cache, gathers 64 validation predictions and writes
              ``best-model.pt`` and the recovery pair (gathered whole). A
              one-device ``from_checkpoint`` session serves that pair:
              log-probs within 1e-3 of a 2x2 mesh session's over the same
              weights on the same 64 requests, top-1 equal. The ViT
              family's sessions at tp=2 and dp=2 against one
              device (``ask_batch`` on 64 requests: 12 attention launches
              (and no bottleneck launch) per forward per rank, at S=197
              and H=6 under tp=2; log-probs
              within the serve gates; fp32 greedy ``generate_batch`` tokens
              equal). With two cards or more, dp=2 also runs with NCCL.
              The times in its line (step ms per rank, ``ask_batch`` ms)
              are gloo's on one card, not a scaling figure. The kernel
              phase holds attention at the mesh's head counts too: H=4,
              D=96, Sk=16 and 64 (SGA at tp=2), H=6, S=197 and 213, D=64
              (ViT and RoBERTa at tp=2); the kernels line gives their
              per-launch numbers under ``tp2_*``.

Attention has three bf16 routes (``ops/attention.py``, ``_route``): the TMA
+ wgmma kernel takes D=64 with 64 <= Sq, Sk <= 256 (the ViT and RoBERTa
self-attentions), the short_kv kernel (persistent blocks fed by TMA,
mma.sync, one pass) 1 <= Sq, Sk <= 64 with D a multiple of 16 (the SGA
blocks), the ``mma.sync`` kernel everything else. The kernel phase checks
each case's route, holds the ``mma.sync`` route (forced through
``_launch(..., route="mma_sync")``) against the plain version at the wgmma
and short_kv routes' shapes too and times the two in turns (old, new, new,
old: ``ms`` is the new route's mean, ``mma_sync_ms`` the old one's);
``kernel_edges`` holds the bf16 routes at the edges of the wgmma route's
range (Sq=Sk=64, 65, 128, 256; Sq=197 over 64 keys; Sq=16 over 197 keys,
which keeps ``mma_sync``), contiguous and on head views, and the backward
there, and at the short_kv route's edges (Sk 1, 15, 17, 63; Sq 1, 17, 64;
D 16 and 128; 512 batches, whose blocks wrap their ring of stages; Sk=65,
which keeps ``mma_sync``). The serve, serve_vit, serve_frcnn, serve_cross,
train timing, serve_from_checkpoint, heatmaps, http and mesh lines check
the launches by route: 6 SGA launches per forward or dropout-0 step
through ``short_kv`` (``fp32`` in the mesh's fp32 steps), none through
``mma_sync``; 12 per ViT forward, 24 per cross-attention forward, 12 per
cache-off or fine-tuned ViT step, 24 per cross-attention step and 12 per
tp=2 rank's ViT forward through ``wgmma``. The train timing lines check
the backward passes by route (``attention_bwd_routes``): 12 through the
backward kernel and none through the plain VJP per fine-tuned ViT step
and per cross-attention step, 6 through the plain VJP per CNN step at
dropout 0 (the SGA), none elsewhere; and the forwards that wrote row
statistics for them (``attention_stats``: 12 per fine-tuned ViT and
cross-attention step, none elsewhere) and the backward passes that
recomputed them (``attention_bwd_stats_recomputed``: none, on every
path; over the cross-attention epoch too). The serving phases write no
statistics (``serve_stats_launches`` in the kernels line: 0). Each train
timing line also gives the step's peak device memory
(``step_peak_mib``).

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
64 requests served from a checkpoint, ``heatmap_launches`` per heatmap
forward of each family, ``http_launches`` over the 65 forwards behind the
HTTP requests, ``okvqa_train_epoch_launches`` over the OK-VQA epoch, the
cache's build included; ``mesh_train_launches_per_step_per_rank``,
``mesh_trainer_launches_per_step_per_rank`` and
``mesh_vit_launches_per_forward_per_rank`` those one rank of the mesh
phase counted per 2x2 step, per step of the 2x2 trainer and per tp=2 ViT
forward; ``frcnn_launches`` and
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
D=64, bf16), with ``vit_mma_sync_ms`` the ``mma.sync`` route's time in
the same turns; ``sga_route`` is the SGA's route, ``mma_sync_ms`` the
``mma.sync`` route's time per forward in the same turns, and
``sga_sk16_*`` / ``sga_sk64_*`` the per-launch numbers at H=8 (B=64,
D=96, Sq=16); ``route_launches``, ``vit_route_launches``,
``frcnn_route_launches``, ``cross_route_launches`` and
``mesh_vit_route_launches_per_forward_per_rank`` split the attention
launches of those runs by route. The ``attention_backward`` entry is the
backward kernel per launch at the RoBERTa shape (``ms`` against the plain
VJP's ``plain_ms`` in the same turns, SDPA's backward as ``library_ms``,
and ``stats_fwd_ms``, the forward a training step runs, which writes the
row statistics the kernel reads, beside the serving forward's
``no_stats_fwd_ms`` in the same turns), its ``launches`` the count over
the cross-attention train epoch, set to 0 just before it; ``vit_*`` and
``tp2_*`` give the other shapes, and the
``*_launches_per_step`` keys the passes by route per step of each train
path. Bounds are the larger of bytes over 3.35
TB/s and FLOPs over the dtype's peak (989 TFLOP/s bf16, 67 TFLOP/s fp32),
H100 SXM data sheet.
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
# Faster-RCNN and cross-attention phases did, 6 for the CNN family before
# the heatmap, HTTP, OK-VQA and optimizer phases did, 4 before the mesh
# phase did; lowered to keep the whole run under 900 s)
ROUNDS = 3             # ask_batch, CNN family
VIT_ROUNDS = 3         # ask_batch and generate_batch, ViT family
FAMILY_ROUNDS = 3      # ask_batch, Faster-RCNN and cross-attention families
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
# Faster-RCNN and cross-attention phases joined the run, 12 and 6 before
# the heatmap, HTTP, OK-VQA and optimizer phases did, 8 and 4 before the
# mesh phase did)
TRAIN_ROUNDS = 6
FAMILY_TRAIN_ROUNDS = 3   # the same, Faster-RCNN and cross-attention
# profiled train steps per configuration: the device's idle share and the
# step's busy time and launches (10 before the ViT family's training phase
# joined the run, 3 before the heatmap, HTTP, OK-VQA and optimizer phases
# did; the profiler's bookkeeping of a step's ~3000-6000 kernels and their
# host operators took ~5 s per step)
TRAIN_WINDOW = 2
# back-to-back forwards in the profiled window of a breakdown line, whose
# idle share they give (10 before the heatmap, HTTP, OK-VQA and optimizer
# phases joined the run)
IDLE_FORWARDS = 5
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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def route_counts(A) -> dict:
    """A copy of the attention wrapper's launches by route."""
    return dict(A.route_launches)


def routes_since(A, before: dict) -> dict:
    """Attention launches by route since ``before`` (a ``route_counts``);
    routes with none are left out."""
    return {r: n - before.get(r, 0) for r, n in A.route_launches.items()
            if n != before.get(r, 0)}


def check_routes(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: attention launches by route {got}, "
                             f"expected {want}")


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
    logs = kernel_build.build(["attention", "attention_bwd", "bottleneck"],
                              ptxas_info=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "device": torch.cuda.get_device_name(0), "card": card,
          "capability": list(cap), "build_dir": kernel_build.BUILD_DIR,
          "bottleneck_ptxas": ptxas_report(logs.get("bottleneck", ""),
                                           "bottleneck_bf16"),
          "attention_short_ptxas": ptxas_report(logs.get("attention", ""),
                                                "attention_short"),
          "attention_tma_ptxas": ptxas_report(logs.get("attention", ""),
                                              "attention_tma"),
          "attention_bwd_ptxas": ptxas_report(logs.get("attention_bwd", ""),
                                              "attention_bwd_tma")})


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers, spill bytes and serialization warnings (C7510-C7519) of
    each instantiation of ``kernel`` in a ``ptxas -v`` report, by its
    template arguments (``<1,64>`` for ``kernel<1, 64>``)."""
    import re

    def args(mangled):
        return "<" + ",".join(re.findall(r"Li(\d+)E", mangled.split(
            kernel, 1)[1].split("EEEv", 1)[0] + "E")) + ">"

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = args(m.group(1)) if kernel in m.group(1) else None
            if fn:        # warnings come before this line: keep them
                out.setdefault(fn, {"warnings": []})
        elif fn and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            out[fn].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                           spill_load_bytes=nums[2])
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
        m = re.search(r"\((C751\d)\).*'([^']+)'", line)
        if m and kernel in m.group(2):
            out.setdefault(args(m.group(2)), {"warnings": []})[
                "warnings"].append(m.group(1))
    return out


ATTENTION_CASES = [       # name, B, H, Sq, Sk, D, launches per forward
    ("sga_sk16", BATCH, 8, 16, 16, 96, 5),
    ("sga_sk64", BATCH, 8, 16, 64, 96, 1),
    ("vit_s197", BATCH, 12, 197, 197, 64, 0),
    ("cross_s213", BATCH, 12, CROSS_SEQ, CROSS_SEQ, 64, 0),
    # the same attentions on a mesh rank at tp=2 (dp=1): half the heads
    ("sga_sk16_tp2", BATCH, 4, 16, 16, 96, 0),
    ("sga_sk64_tp2", BATCH, 4, 16, 64, 96, 0),
    ("vit_s197_tp2", BATCH, 6, 197, 197, 64, 0),
    ("cross_s213_tp2", BATCH, 6, CROSS_SEQ, CROSS_SEQ, 64, 0),
]
# the kernel phase's per-launch numbers kept for the kernels line, by case
PER_LAUNCH_CASES = {"sga_sk16": "sga_sk16", "sga_sk64": "sga_sk64",
                    "vit_s197": "vit", "cross_s213": "cross",
                    "sga_sk16_tp2": "tp2_sga_sk16",
                    "sga_sk64_tp2": "tp2_sga_sk64",
                    "vit_s197_tp2": "tp2_vit_s197",
                    "cross_s213_tp2": "tp2_cross_s213"}


def phase_attention(torch):
    import torch.nn.functional as F
    from t5_resnet_vqa_torch.ops import attention as A

    per_forward = {"ms": 0.0, "mma_sync_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                   "library_ms": 0.0, "max_abs_err": 0.0, "bwd_ms": 0.0,
                   "plain_bwd_ms": 0.0, "library_bwd_ms": 0.0,
                   "bwd_bound_ms": 0.0, "bwd_max_abs_err": 0.0}
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
            route = A._route(qv, kv, vv)
            want_route = ("fp32" if dtype_name == "float32" else
                          "wgmma" if D == 64 else "short_kv")
            if route != want_route or A._route(q, k, v) != route:
                raise AssertionError(f"attention {name} {dtype_name}: route "
                                     f"{route}, expected {want_route}")
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
            older = {}
            if route in ("wgmma", "short_kv"):
                # the mma.sync route on the same inputs: checked, then
                # timed in turns with the new one (old, new, new, old)
                a, r = rel_err(A._launch(qv, kv, vv, route="mma_sync"), want)
                if not r <= ATT_TOL[dtype_name]:
                    raise AssertionError(
                        f"attention {name} on the mma_sync route: max-abs "
                        f"error {a} ({r} of max|ref|) > {ATT_TOL[dtype_name]}")
                older = {"mma_sync_max_abs_err": a}
                routes = (lambda: A._launch(q, k, v, route="mma_sync"),
                          lambda: A.fused_attention(q, k, v))
                turns = [device_ms(torch, routes[i]) for i in (0, 1, 1, 0)]
                ms = (turns[1] + turns[2]) / 2
                older.update({"mma_sync_ms": (turns[0] + turns[3]) / 2,
                              "turns_ms": turns})
            if route == "wgmma":
                # the forward a training step runs, which also writes the
                # row statistics, in turns with the serving one (without,
                # with, with, without) on the main path's head views
                fwds = (lambda: A._launch(qv, kv, vv),
                        lambda: A._launch(qv, kv, vv, stats=True))
                turns = [device_ms(torch, fwds[i]) for i in (0, 1, 1, 0)]
                older.update({"stats_fwd_ms": (turns[1] + turns[2]) / 2,
                              "no_stats_fwd_ms": (turns[0] + turns[3]) / 2,
                              "stats_fwd_turns_ms": turns})
            else:
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
                    "route": route, "max_abs_err": abs_err, "rel_err": rel,
                    "tol": ATT_TOL[dtype_name], "ms": ms,
                    "ms_head_views": views_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                    "bound_share": max(t_bytes, t_ops) / ms,
                    "bound_by": bound_by(t_bytes, t_ops), **older}
            # every shape is on a training path: the SGA's at dropout 0,
            # the ViT's with the cache off or a fine-tuned tower, RoBERTa's
            # in every cross-attention step
            bwd = attention_backward(torch, A, B, H, Sq, Sk, D, dtype,
                                     dtype_name, name)
            line.update(bwd)
            emit(line)
            if dtype_name == "bfloat16" and name in PER_LAUNCH_CASES:
                per_forward[PER_LAUNCH_CASES[name]] = {
                    "route": route, **older, "ms": ms,
                    "ms_head_views": views_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": bound_by(t_bytes, t_ops),
                    "max_abs_err": abs_err, **bwd}
            if dtype_name == "bfloat16" and n_fwd:
                per_forward["route"] = route
                per_forward["ms"] += n_fwd * ms
                per_forward["mma_sync_ms"] += n_fwd * older["mma_sync_ms"]
                per_forward["plain_ms"] += n_fwd * plain_ms
                per_forward["library_ms"] += n_fwd * lib_ms
                for key in ("bwd_ms", "plain_bwd_ms", "library_bwd_ms",
                            "bwd_bound_ms"):
                    per_forward[key] += n_fwd * bwd[key]
                add_bound(per_forward, n_fwd, t_bytes, t_ops)
                per_forward["max_abs_err"] = max(per_forward["max_abs_err"],
                                                 abs_err)
                per_forward["bwd_max_abs_err"] = max(
                    per_forward["bwd_max_abs_err"], line["bwd_max_abs_err"])
    return per_forward


# the wgmma route's edges (D=64, bf16): Sq, Sk and the route each must take
ATTENTION_EDGES = [(64, 64, "wgmma"), (65, 65, "wgmma"), (128, 128, "wgmma"),
                   (256, 256, "wgmma"), (197, 64, "wgmma"),
                   (16, 197, "mma_sync")]
EDGE_BATCH, EDGE_HEADS = 8, 12
# the short_kv route's edges (bf16, 1 <= Sq, Sk <= 64, D a multiple of 16):
# Sq, Sk, D, the batch and the route each must take; at batch 512 each
# block's ring of stages wraps several times (6144 heads over <= 132 blocks)
SHORT_KV_EDGES = [(16, 1, 96, 8, "short_kv"), (16, 15, 96, 8, "short_kv"),
                  (16, 17, 96, 8, "short_kv"), (16, 63, 96, 8, "short_kv"),
                  (1, 64, 96, 8, "short_kv"), (17, 64, 96, 8, "short_kv"),
                  (64, 64, 96, 8, "short_kv"), (16, 64, 16, 8, "short_kv"),
                  (16, 64, 128, 8, "short_kv"), (16, 64, 96, 512, "short_kv"),
                  (16, 65, 96, 8, "mma_sync")]


def phase_attention_edges(torch):
    """The bf16 routes at the edges of the wgmma and short_kv routes'
    ranges, contiguous and on head views, against the plain version
    (ATT_TOL); and, at the wgmma route's edges, the
    backward there (the kernel where the forward takes the wgmma route, the
    plain VJP elsewhere, one pass counted on its route) against the plain
    VJP, the gradient as the main path hands it back."""
    from t5_resnet_vqa_torch.ops import attention as A

    cases = []
    for Sq, Sk, want_route in ATTENTION_EDGES:
        g = torch.Generator(device=DEVICE).manual_seed(Sq * 1000 + Sk)
        for views in (False, True):
            if views:
                q, k, v = (torch.randn(EDGE_BATCH, s, EDGE_HEADS * 64,
                                       device=DEVICE, generator=g)
                           .to(torch.bfloat16)
                           .reshape(EDGE_BATCH, s, EDGE_HEADS, 64)
                           .transpose(1, 2) for s in (Sq, Sk, Sk))
            else:
                q, k, v = (torch.randn(EDGE_BATCH, EDGE_HEADS, s, 64,
                                       device=DEVICE, generator=g)
                           .to(torch.bfloat16) for s in (Sq, Sk, Sk))
            before = route_counts(A)
            got = A.fused_attention(q, k, v)
            want = A.attention_reference(q, k, v)
            torch.cuda.synchronize()
            check_routes(f"attention edge Sq={Sq} Sk={Sk}",
                         routes_since(A, before), {want_route: 1})
            a, r = rel_err(got, want)
            if not r <= ATT_TOL["bfloat16"]:
                raise AssertionError(
                    f"attention edge Sq={Sq} Sk={Sk} views={views}: max-abs "
                    f"error {a} ({r} of max|ref|) > {ATT_TOL['bfloat16']}")
            grad_out = torch.randn(EDGE_BATCH, Sq, EDGE_HEADS, 64,
                                   device=DEVICE, generator=g) \
                .to(torch.bfloat16).transpose(1, 2)
            bwd_route = "wgmma" if want_route == "wgmma" else "plain"
            before = dict(A.bwd_route_launches)
            grads = A.attention_backward(q, k, v, grad_out)
            torch.cuda.synchronize()
            check_bwd_routes(f"attention backward edge Sq={Sq} Sk={Sk}",
                             bwd_routes_since(A, before), {bwd_route: 1})
            bwd_a = bwd_r = 0.0
            for grad, ref in zip(grads, A.attention_backward(
                    q, k, v, grad_out, route="plain")):
                ga, gr = rel_err(grad, ref)
                if not gr <= ATT_TOL["bfloat16"]:
                    raise AssertionError(
                        f"attention backward edge Sq={Sq} Sk={Sk} "
                        f"views={views}: max-abs error {ga} ({gr} of "
                        f"max|ref|) > {ATT_TOL['bfloat16']}")
                bwd_a, bwd_r = max(bwd_a, ga), max(bwd_r, gr)
            cases.append({"Sq": Sq, "Sk": Sk, "head_views": views,
                          "route": want_route, "max_abs_err": a,
                          "rel_err": r, "bwd_route": bwd_route,
                          "bwd_max_abs_err": bwd_a, "bwd_rel_err": bwd_r})
    emit({"phase": "kernel_edges", "kernel": "attention", "dtype": "bfloat16",
          "batch": EDGE_BATCH, "heads": EDGE_HEADS, "D": 64,
          "tol": ATT_TOL["bfloat16"], "cases": cases})
    # the short_kv route's edges, forward only (its backward is the plain
    # VJP, held above wherever the route is not wgmma)
    cases = []
    for Sq, Sk, D, B, want_route in SHORT_KV_EDGES:
        g = torch.Generator(device=DEVICE).manual_seed(Sq * 1000 + Sk + D)
        for views in (False, True):
            if views:
                q, k, v = (torch.randn(B, s, EDGE_HEADS * D, device=DEVICE,
                                       generator=g).to(torch.bfloat16)
                           .reshape(B, s, EDGE_HEADS, D).transpose(1, 2)
                           for s in (Sq, Sk, Sk))
            else:
                q, k, v = (torch.randn(B, EDGE_HEADS, s, D, device=DEVICE,
                                       generator=g).to(torch.bfloat16)
                           for s in (Sq, Sk, Sk))
            before = route_counts(A)
            got = A.fused_attention(q, k, v)
            want = A.attention_reference(q, k, v)
            torch.cuda.synchronize()
            check_routes(f"attention edge Sq={Sq} Sk={Sk} D={D} B={B}",
                         routes_since(A, before), {want_route: 1})
            a, r = rel_err(got, want)
            if not r <= ATT_TOL["bfloat16"]:
                raise AssertionError(
                    f"attention edge Sq={Sq} Sk={Sk} D={D} B={B} "
                    f"views={views}: max-abs error {a} ({r} of max|ref|) > "
                    f"{ATT_TOL['bfloat16']}")
            cases.append({"Sq": Sq, "Sk": Sk, "D": D, "batch": B,
                          "head_views": views, "route": want_route,
                          "max_abs_err": a, "rel_err": r})
    emit({"phase": "kernel_edges", "kernel": "attention", "dtype": "bfloat16",
          "heads": EDGE_HEADS, "routes": "short_kv",
          "tol": ATT_TOL["bfloat16"], "cases": cases})


def bwd_routes_since(A, before: dict) -> dict:
    """Attention backward passes by route since ``before`` (a copy of
    ``A.bwd_route_launches``); routes with none are left out."""
    return {r: n - before.get(r, 0) for r, n in A.bwd_route_launches.items()
            if n != before.get(r, 0)}


def check_bwd_routes(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: attention backward passes by route "
                             f"{got}, expected {want}")


def check_stats(what: str, got: dict, forwards: int) -> None:
    """``forwards`` forwards wrote row statistics, and no backward pass
    recomputed them (``got``: a run's ``attention_stats`` and
    ``attention_bwd_stats_recomputed``)."""
    if (got["attention_stats"], got["attention_bwd_stats_recomputed"]) != (
            forwards, 0):
        raise AssertionError(
            f"{what}: {got['attention_stats']} forwards wrote row "
            f"statistics (expected {forwards}), "
            f"{got['attention_bwd_stats_recomputed']} backward passes "
            f"recomputed them (expected 0)")


def attention_backward(torch, A, B, H, Sq, Sk, D, dtype, dtype_name, name):
    """Kernel 1's backward on the head views of [B, S, H*D] projections,
    with the output's gradient as the main path hands it back (the
    [B, H, Sq, D] view of a contiguous [B, Sq, H, D]): the route's backward
    (``A.attention_backward``: the kernel where the forward takes the wgmma
    route, the plain VJP elsewhere) against the plain version's own backward
    (autograd of ``attention_reference``) within ATT_TOL, one pass counted on
    its route; the device ms of the route's backward and of the plain VJP
    (the forced "plain" route; on the kernel's route the two in turns:
    plain, kernel, kernel, plain), of the plain version's own backward and
    of SDPA's backward on the same views, and the bound: q, k, v and the
    gradient read once, dq, dk and dv written once, 5 products."""
    import torch.nn.functional as F

    g = torch.Generator(device=DEVICE).manual_seed(6)
    q, k, v = (torch.randn(B, s, H * D, device=DEVICE, generator=g).to(dtype)
               .reshape(B, s, H, D).transpose(1, 2) for s in (Sq, Sk, Sk))
    grad_out = torch.randn(B, Sq, H, D, device=DEVICE, generator=g) \
        .to(dtype).transpose(1, 2)
    route = A._bwd_route(q, k, v)

    def graph(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, grad_out,
                                           retain_graph=True)

    before = dict(A.bwd_route_launches)
    recomputed = A.bwd_stats_recomputed
    got = A.attention_backward(q, k, v, grad_out)
    torch.cuda.synchronize()
    check_bwd_routes(f"attention backward {name} {dtype_name}",
                     bwd_routes_since(A, before), {route: 1})
    stats = None
    if route == "wgmma":
        # without statistics it computed them (counted); with the forward's
        # it gives the same gradients, to the bit
        if A.bwd_stats_recomputed != recomputed + 1:
            raise AssertionError(f"attention backward {name}: row "
                                 f"statistics not recomputed once")
        _, stats = A._launch(q, k, v, stats=True)
        for a, b in zip(A.attention_backward(q, k, v, grad_out, stats=stats),
                        got):
            if not torch.equal(a, b):
                raise AssertionError(f"attention backward {name}: the "
                                     f"forward's statistics give other "
                                     f"gradients than recomputed ones")
    plain_bwd = graph(A.attention_reference)
    abs_err = rel = 0.0
    for grad, want in zip(got, plain_bwd()):
        a, r = rel_err(grad, want)
        if not r <= ATT_TOL[dtype_name]:
            raise AssertionError(
                f"attention backward {name} {dtype_name}: max-abs error "
                f"{a} ({r} of max|ref|) > {ATT_TOL[dtype_name]}")
        abs_err, rel = max(abs_err, a), max(rel, r)
    out = {"bwd_route": route, "bwd_max_abs_err": abs_err,
           "bwd_rel_err": rel}
    if route == "wgmma":
        fns = (lambda: A.attention_backward(q, k, v, grad_out,
                                            route="plain"),
               lambda: A.attention_backward(q, k, v, grad_out, stats=stats))
        turns = [device_ms(torch, fns[i]) for i in (0, 1, 1, 0)]
        out.update({"bwd_ms": (turns[1] + turns[2]) / 2,
                    "plain_vjp_ms": (turns[0] + turns[3]) / 2,
                    "bwd_turns_ms": turns})
    else:
        out["bwd_ms"] = out["plain_vjp_ms"] = device_ms(
            torch, lambda: A.attention_backward(q, k, v, grad_out))
    out["plain_bwd_ms"] = device_ms(torch, plain_bwd)
    out["library_bwd_ms"] = device_ms(
        torch, graph(F.scaled_dot_product_attention))
    nbytes = (3 * Sq + 4 * Sk) * B * H * D * q.element_size()
    t_bytes, t_ops = bound_terms(nbytes, 10.0 * B * H * Sq * Sk * D,
                                 dtype_name)
    out.update({"bwd_bound_ms": max(t_bytes, t_ops),
                "bwd_bound_by": bound_by(t_bytes, t_ops),
                "bwd_bound_share": max(t_bytes, t_ops) / out["bwd_ms"],
                "bwd_vs_library": out["bwd_ms"] / out["library_bwd_ms"]})
    return out


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
                   "library_ms": None, "library_chain_ms": 0.0,
                   "max_abs_err": 0.0}
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
            plain_ms = device_ms(torch, lambda: K.bottleneck_reference(
                x, *ops, stride=stride), iters=5)
            x_nchw = x.permute(0, 3, 1, 2)
            kernel = (lambda: K.fused_bottleneck_packed(x, packed,
                                                        stride=stride))
            chain_ms = chain_err = turns = None
            with torch.inference_mode():
                module_ms = device_ms(torch, lambda: block(x_nchw))
                if dtype_name == "bfloat16":
                    # the main path's dtype: kernel and cuDNN chain in
                    # turns (kernel, chain, chain, kernel)
                    chain = library_chain(torch, ops, stride)
                    chain_err = rel_err(chain(x_nchw).permute(0, 2, 3, 1),
                                        want)[1]
                    fns = (kernel, lambda: chain(x_nchw))
                    turns = [device_ms(torch, fns[i]) for i in (0, 1, 1, 0)]
                    ms = (turns[0] + turns[3]) / 2
                    chain_ms = (turns[1] + turns[2]) / 2
                else:
                    ms = device_ms(torch, kernel)
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
                  "library_chain_ms": chain_ms,
                  "library_chain_rel_err": chain_err, "turns_ms": turns,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_share": max(t_bytes, t_ops) / ms,
                  "bound_by": bound_by(t_bytes, t_ops),
                  "weight_stream_mb": streamed_weight_bytes(
                      H, cin, width, stride, ds, x.element_size(),
                      torch.cuda.get_device_properties(0)
                      .multi_processor_count) / 1e6})
            if dtype_name == "bfloat16":
                per_forward["ms"] += n_fwd * ms
                per_forward["plain_ms"] += n_fwd * plain_ms
                per_forward["library_chain_ms"] += n_fwd * chain_ms
                add_bound(per_forward, n_fwd, t_bytes, t_ops)
                per_forward["max_abs_err"] = max(per_forward["max_abs_err"],
                                                 abs_err)
    return per_forward


def library_chain(torch, ops, stride):
    """The block as a chain of cuDNN calls on channels-last NCHW views: the
    folded weights and biases (in the activation dtype) through
    ``F.conv2d``, ReLU, the add and ReLU. A yardstick for the fused kernel's
    time, not a reference: its t1 and t2 go through device memory and its
    biases are rounded to the activation dtype."""
    import torch.nn.functional as F

    w1, b1, w2, b2, w3, b3, wd, bd = ops
    dt = w1.dtype
    cl = torch.channels_last

    def conv(w, kh):      # [kh*kh*I, O] tap-major -> OIHW, channels-last
        k = w.reshape(kh, kh, -1, w.shape[-1]).permute(3, 2, 0, 1)
        return k.contiguous(memory_format=cl)

    k1, k2, k3 = conv(w1, 1), conv(w2, 3), conv(w3, 1)
    kd = None if wd is None else conv(wd, 1)
    b1, b2, b3 = (b.to(dt) for b in (b1, b2, b3))
    bd = None if bd is None else bd.to(dt)

    def run(x):
        t = torch.relu(F.conv2d(x, k1, b1))
        t = torch.relu(F.conv2d(t, k2, b2, stride=stride, padding=1))
        idn = x if kd is None else F.conv2d(x, kd, bd, stride=stride)
        return torch.relu(F.conv2d(t, k3, b3) + idn)

    return run


def streamed_weight_bytes(H, cin, cw, stride, ds, itemsize, sms) -> float:
    """Weight bytes one launch streams from L2, by the shapes: every
    output tile (8x16 pixels at stride 1, 4x16 at stride 2) reads each
    weight once (w1 once per conv1 pass: one at stride 1, two at stride 2
    in bf16; per 64-row pass in fp32), bf16 and fp32 weights unpadded.
    In bf16 at stride 1 with width 64 each of the ``sms`` persistent blocks
    reads w2 once and keeps it."""
    th, tw = (8 if stride == 1 and itemsize == 2 else 4), 16
    ho = H // stride
    tiles = BATCH * -(-ho // th) * -(-ho // tw)
    halo = ((th - 1) * stride + 3) * ((tw - 1) * stride + 3)
    passes = stride if itemsize == 2 else -(-halo // 64)
    cout = 4 * cw
    w2 = itemsize * 9 * cw * cw
    resident = itemsize == 2 and stride == 1 and cw == 64
    per_tile = itemsize * (passes * cin * cw
                           + cout * (cw + (cin if ds else 0)))
    return float(tiles * (per_tile + (0 if resident else w2))
                 + (min(tiles, sms) * w2 if resident else 0))


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
    routes = route_counts(A)
    first_ms, results = serve_ms(torch, session, requests)
    launches = {"attention": A.launches, "bottleneck": K.launches}
    if launches != {"attention": 6 * CHUNKS, "bottleneck": 7 * CHUNKS}:
        raise AssertionError(f"launch counts {launches}, expected 6 and 7 "
                             f"per forward over {CHUNKS} forwards")
    launches["attention_routes"] = routes_since(A, routes)
    check_routes("CNN serve", launches["attention_routes"],
                 {"short_kv": 6 * CHUNKS})
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
    over IDLE_FORWARDS back-to-back forwards, with its busy time and its
    elapsed time both taken in one profiled window (the profiler's own host
    work is in that window); the forward's busiest kernels. Emits the line
    and returns it."""
    with torch.inference_mode():
        wall = {name: cuda_ms(torch, fn, iters=10)
                for name, fn in parts.items()}
        device = {name: profile_device(torch, fn, iters=1)
                  for name, fn in parts.items()}
        window = profile_device(torch, parts["forward"],
                                iters=IDLE_FORWARDS)
    line = {"phase": phase, "config": label, "card": card,
            "batch": BATCH, "dtype": "bfloat16",
            "forward_pairs_per_s": BATCH / (wall["forward"] / 1e3),
            "event_ms": wall,
            "rest_ms": wall["forward"] - sum(v for k, v in wall.items()
                                             if k != "forward"),
            "device_busy_ms": {k: v["busy_ms"] for k, v in device.items()},
            "kernel_launches": {k: v["launches"] for k, v in device.items()},
            "device_idle_share": 1.0 - window["busy_ms"] / window["elapsed_ms"],
            "idle_window": {"forwards": IDLE_FORWARDS,
                            "busy_ms": window["busy_ms"],
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
    routes = route_counts(A)
    first_ms, results = serve_ms(torch, session, requests)
    launches = {"attention": A.launches, "bottleneck": K.launches}
    if launches != {"attention": 12 * CHUNKS, "bottleneck": 0}:
        raise AssertionError(f"ViT launch counts {launches}, expected 12 "
                             f"attention per forward over {CHUNKS} forwards")
    launches["attention_routes"] = routes_since(A, routes)
    check_routes("ViT serve", launches["attention_routes"],
                 {"wgmma": 12 * CHUNKS})
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
# build function, image size, (attention, bottleneck) launches per forward,
# the bf16 attention route, and the vision model name (and language model)
# of the trainer's config
FAMILIES = {
    "frcnn": {"session": "cnn", "build": _build_frcnn_model, "size": IMAGE,
              "launches": (6, 7), "route": "short_kv", "vision": "faster-rcnn",
              "lang": "t5-base", "model": "resnet50-fpn + t5-base + 3xSGA"},
    "cross": {"session": "cross_attention", "build": _build_cross_model,
              "size": VIT_IMAGE, "launches": (24, 0), "route": "wgmma",
              "vision": VIT_NAME, "lang": "roberta-base",
              "model": "vit-base x roberta-base"},
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
    routes = route_counts(A)
    first_ms, results = serve_ms(torch, session, requests)
    launches = {"attention": A.launches, "bottleneck": K.launches}
    per_forward = dict(zip(("attention", "bottleneck"), spec["launches"]))
    if launches != {k: n * CHUNKS for k, n in per_forward.items()}:
        raise AssertionError(f"{family} launch counts {launches}, expected "
                             f"{per_forward} per forward over {CHUNKS} "
                             f"forwards")
    launches["attention_routes"] = routes_since(A, routes)
    check_routes(f"{family} serve", launches["attention_routes"],
                 {spec["route"]: per_forward["attention"] * CHUNKS})
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
        # the SGA's forwards on the short_kv route and their backward
        # passes on the plain VJP (D=96), only at dropout 0 (production SGA
        # dropout takes the plain path both ways)
        for dropout, fwd, bwd in ((False, {"short_kv": 6}, {"plain": 6}),
                                  (True, {}, {})):
            for label in ("kernels_on", "kernels_off"):
                what = (f"CNN {label} train step, dropout "
                        f"{'production' if dropout else 0}")
                got = timing[dropout][label]["launches_per_step"]
                on = label == "kernels_on"
                check_routes(what, got["attention_routes"],
                             fwd if on else {})
                check_bwd_routes(what, got["attention_bwd_routes"],
                                 bwd if on else {})
                check_stats(what, got, 0)
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
    per_step["attention"]["cache_off_dropout_0_bwd_routes"] = timing[False][
        "kernels_on"]["launches_per_step"]["attention_bwd_routes"]
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
        # the fine-tuned tower's 12 backward passes take the kernel
        # (and their forwards wrote the row statistics the backward took)
        for label, want in (("cached", ({}, {}, 0)),
                            ("cache_off", ({"wgmma": 12}, {}, 0)),
                            ("fine_tuned", ({"wgmma": 12}, {"wgmma": 12},
                                            12))):
            got = timing[label]["launches_per_step"]
            check_routes(f"ViT {label} train step", got["attention_routes"],
                         want[0])
            check_bwd_routes(f"ViT {label} train step",
                             got["attention_bwd_routes"], want[1])
            check_stats(f"ViT {label} train step", got, want[2])
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
    per_step["attention"]["fine_tuned_bwd_routes"] = \
        timing["fine_tuned"]["launches_per_step"]["attention_bwd_routes"]
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
        # the backward's counts from 0 just before the main path's epoch:
        # the cross-attention family's 12 RoBERTa layers each take the
        # kernel's backward once per train step
        A.bwd_route_launches.update({r: 0 for r in A.bwd_route_launches})
        A.stats_launches = A.bwd_stats_recomputed = 0
        reloaded, epoch = train_epoch(torch, cfg, build, data, expect,
                                      log_lines)
        epoch["attention_bwd_routes"] = {
            r: n for r, n in A.bwd_route_launches.items() if n}
        epoch["attention_stats"] = A.stats_launches
        epoch["attention_bwd_stats_recomputed"] = A.bwd_stats_recomputed
        check_bwd_routes(f"{family} epoch", epoch["attention_bwd_routes"],
                         {"wgmma": 12 * TRAIN_BATCHES}
                         if family == "cross" else {})
        check_stats(f"{family} epoch", epoch,
                    12 * TRAIN_BATCHES if family == "cross" else 0)
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
        # production dropout: the SGA's attention takes the plain path, the
        # cross-attention family's 24 launches and 12 backward passes the
        # wgmma route and the backward kernel
        for label in timing:
            got = timing[label]["launches_per_step"]
            want = (({"wgmma": 24}, {"wgmma": 12}, 12) if family == "cross"
                    else ({}, {}, 0))
            check_routes(f"{family} {label} train step",
                         got["attention_routes"], want[0])
            check_bwd_routes(f"{family} {label} train step",
                             got["attention_bwd_routes"], want[1])
            check_stats(f"{family} {label} train step", got, want[2])
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
    per_step["attention"]["bwd_routes_per_production_step"] = {
        r: n // TRAIN_BATCHES
        for r, n in epoch["attention_bwd_routes"].items()}
    emit({"phase": f"train_{family}", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return {"epoch": epoch["launches"], "per_step": per_step,
            "epoch_bwd_routes": epoch["attention_bwd_routes"],
            "epoch_stats": epoch["attention_stats"],
            "epoch_bwd_stats_recomputed":
                epoch["attention_bwd_stats_recomputed"]}


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
    loss), its kernels' launches per step (the attention backward passes by
    route among them), the peak device memory of one step
    (``torch.cuda.max_memory_allocated``, and above what was held before
    it), and each one's device busy ms
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
        a0, k0, r0 = A.launches, K.launches, route_counts(A)
        b0 = dict(A.bwd_route_launches)
        s0, c0 = A.stats_launches, A.bwd_stats_recomputed
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps[label]()
        peak = torch.cuda.max_memory_allocated()
        counts = {"attention": A.launches - a0, "bottleneck": K.launches - k0,
                  "attention_routes": routes_since(A, r0),
                  "attention_bwd_routes": bwd_routes_since(A, b0),
                  "attention_stats": A.stats_launches - s0,
                  "attention_bwd_stats_recomputed":
                      A.bwd_stats_recomputed - c0}
        median = float(np.median(times[label]))
        line = {"phase": phase, "config": label, "card": card,
                "dropout": "production" if dropout else 0.0,
                "dtype": "bfloat16", "batch": BATCH,
                "train_step_ms": median,
                "train_samples_per_s": BATCH / (median / 1e3),
                "fastest_step_ms": float(min(times[label])),
                "launches_per_step": counts,
                "step_peak_mib": peak / 2**20,
                "step_peak_above_held_mib": (peak - held) / 2**20,
                "steps_ms": times[label]}
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
# per family: the bf16 route of its attention launches (the SGA's short_kv,
# the ViT's and RoBERTa's wgmma); no main path launches mma_sync
SERVED_ROUTES = {"cnn": "short_kv", "vit": "wgmma",
                 **{f: spec["route"] for f, spec in FAMILIES.items()}}


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
        # the SGA's attention runs attention_short (the short_kv route)
        names = {k: k in text for k in ("attention_short", "bottleneck_bf16")}
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
            routes = route_counts(A)
            results = session.ask_batch(requests, top_k=ANSWERS)
            launches = {"attention": A.launches, "bottleneck": K.launches}
            routes = routes_since(A, routes)
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
        check_routes(f"{family} served from a checkpoint", routes,
                     {SERVED_ROUTES[family]: want_launches["attention"]})
        if not (diff <= SERVED_TOL and top1_equal):
            raise AssertionError(f"served log-probs {diff} from the "
                                 f"trainer's eval (tolerance {SERVED_TOL}),"
                                 f" top-1 equal {top1_equal}")
        torch.cuda.empty_cache()
        line = {"phase": "serve_from_checkpoint", "family": family,
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
        return session, data, line
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_serve_from_checkpoint(torch, card):
    """Every family served from a checkpoint. Returns the launch counts and
    {family: (session, data)} of the families the heatmap and HTTP phases
    serve again (CNN, Faster-RCNN, ViT)."""
    lines, kept = {}, {}
    for f in SERVED_LAUNCHES:
        session, data, lines[f] = serve_from_checkpoint_family(torch, card, f)
        emit(lines[f])
        if f in HEATMAP_MODES:
            kept[f] = (session, data)
        del session
        torch.cuda.empty_cache()
    return {name: {f: line["launches"][name] for f, line in lines.items()}
            for name in ("attention", "bottleneck")}, kept


# ------------------------------------------------ the serving and evaluation
# surfaces and the rest of the host side

# heatmaps: the mode of each family, the top k, and the device step's
# (attention, bottleneck) launches per forward
HEATMAP_MODES = {"cnn": "cam", "frcnn": "cam", "vit": "rollout"}
HEATMAP_TOP_K = 3
HEATMAP_LAUNCHES = {"cam": (6, 7), "rollout": (0, 0)}
# CAMs, kernels on against off in bf16: the channel mean of the features of
# a bf16 tower whose blocks run fused or unfused, relative to the features'
# largest magnitude (the kernel phase's BLOCK_TOL: a mean is off by no more
# than what it averages). The gate reads the mean before the min-max
# scaling, and relative to the features, not to the mean: over 256-2048
# channels of both signs the mean is a small share of the features'
# magnitude, and the scaling divides by each map's range, a small share of
# the mean's on seeded weights and noise images; the line reports both
# ratios and the scaled maps' difference
CAM_TOL = 2e-2
# the device's rollout mask against the numpy one on host copies of the same
# fp32 maps: the same products in the same order, summed by other libraries
ROLLOUT_TOL = 1e-5
HEATMAP_ROUNDS = 5
# the collate keys the model does not take (generate_heatmaps's)
_EVAL_KEYS = ("answers", "questions", "image_fns", "annotation_ids")

HTTP_FAMILIES = ("cnn", "vit")

OKVQA_TRAIN_BATCHES = 4
OKVQA_TEST_BATCHES = 1
OKVQA_IMAGES = {"train": 128, "val": 64}   # 192 unique: 3 cache chunks
# (attention, bottleneck) launches of the cache's build, of each train step
# (cached, production dropout) and of each eval forward
OKVQA_LAUNCHES = {"cache_build": (0, 7 * 3), "train": (0, 0), "eval": (6, 0)}

OPT_STEPS = 3
# the card's update against the same optimizer stepped on CPU copies of the
# same fp32 parameters, clipped gradients and state: the same fp32 math, but
# other reduction orders and other last bits of rsqrt and fused multiplies,
# so an element now and then rounds to the neighbouring fp32 value of its
# parameter. One such step is 6e-8 of the parameter, so its share of the
# update falls as the update grows: at 1e-2 (OPT_LR, every group) it stays
# far below OPT_TOL, at 1e-4 it would not.
OPT_TOL = 1e-5
OPT_LR = 1e-2
OPT_ROUNDS = 5
OPTIMIZERS = {"SGD": {"momentum": 0.9}, "Lamb": {"weight_decay": 0.1},
              "Adafactor": {}}


def _model_batch(torch, batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEVICE)
            for k, v in batch.items()
            if k not in _EVAL_KEYS and not k.startswith("_")}


def _plain_vit(session, plain: bool):
    """The ViT tower's attention on its plain path (``plain``) or on the
    kernel: the path rollout takes, which needs the maps."""
    for layer in session.model.vision_model.encoder.layer:
        layer.attention.attention.use_kernel = not plain


def heatmap_family(torch, card, family, session, data):
    """The heatmap device step on one test batch of 64 of a session served
    from a checkpoint (bf16): launches, maps, top-k against ``ask_batch``
    on the same requests, kernels on against off (CAM) or the device's mask
    against the numpy one (rollout), timings and host bytes."""
    from t5_resnet_vqa_torch.data import DataLoader
    from t5_resnet_vqa_torch.eval.wups import wup_measure
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train.trainer import prepare_model
    from t5_resnet_vqa_torch.viz import (
        heatmap_step,
        make_infer_fn,
        rollout_mask,
        rollout_mask_batch,
    )

    mode = HEATMAP_MODES[family]
    answers, _, test_ds, load_images = data
    samples = test_ds[:BATCH]
    requests = [(s.image_path, s.question.question_text) for s in samples]
    with seeded_images(load_images):
        batch = next(iter(DataLoader(samples, session.collate, BATCH)))
    targets = np.asarray(batch["annotation_ids"])
    device_batch = _model_batch(torch, batch)
    autocast = lambda: torch.autocast(DEVICE, dtype=torch.bfloat16)

    def step(model):
        with torch.inference_mode(), autocast():
            return heatmap_step(model, device_batch, mode, HEATMAP_TOP_K)

    model = session.model.eval()
    step(model)
    torch.cuda.synchronize()
    A.launches = 0
    K.launches = 0
    routes = route_counts(A)
    out = step(model)
    topk = out["topk"].cpu().numpy()
    maps = out["maps"].cpu().numpy()
    launches = {"attention": A.launches, "bottleneck": K.launches}
    want = dict(zip(("attention", "bottleneck"), HEATMAP_LAUNCHES[mode]))
    if launches != want:
        raise AssertionError(f"{family} heatmap launches {launches}, "
                             f"expected {want}")
    check_routes(f"{family} heatmap", routes_since(A, routes),
                 {SERVED_ROUTES[family]: want["attention"]}
                 if want["attention"] else {})
    # C5 (stride 32), the FPN's pool level (stride 64), 16x16 patches
    grid = {"cnn": IMAGE // 32, "frcnn": IMAGE // 64,
            "vit": VIT_IMAGE // 16}[family]
    if maps.shape != (BATCH, grid, grid) or not np.isfinite(maps).all():
        raise AssertionError(f"{family} maps of shape {maps.shape}, finite "
                             f"{np.isfinite(maps).all()}")
    if mode == "cam" and not (maps.min() >= 0.0 and maps.max() <= 1.0):
        raise AssertionError(f"CAMs outside [0, 1]: {maps.min()}, "
                             f"{maps.max()}")

    # the same requests through ask_batch: the ViT tower on the plain path
    # the rollout forward takes (it needs the maps)
    if mode == "rollout":
        _plain_vit(session, True)
    with seeded_images(load_images):
        results = session.ask_batch(requests, top_k=HEATMAP_TOP_K)
        served_lp = session._predict(session._to_device(
            session._collate_chunk(requests))).float().cpu().numpy()
    if mode == "rollout":
        _plain_vit(session, False)
    logprob_diff = float(np.abs(out["log_probs"].float().cpu().numpy()
                                - served_lp).max())
    heat_answers = [[answers[int(i)] for i in row] for row in topk]
    if heat_answers != [r["top_answers"] for r in results]:
        bad = sum(h != r["top_answers"] for h, r in zip(heat_answers,
                                                        results))
        raise AssertionError(f"{family}: the heatmap's top-{HEATMAP_TOP_K} "
                             f"differs from ask_batch's in {bad} rows "
                             f"(log-probs {logprob_diff} apart)")

    def routing(ranked):
        return [any(wup_measure(a, answers[int(t)]) == 1.0 for a in row)
                for row, t in zip(ranked, targets)]

    def avg_wups(ranked):
        return float(np.mean([wup_measure(row[0], answers[int(t)])
                              for row, t in zip(ranked, targets)]))

    served_answers = [r["top_answers"] for r in results]
    perfect = routing(heat_answers)
    if perfect != routing(served_answers) or \
            avg_wups(heat_answers) != avg_wups(served_answers):
        raise AssertionError(f"{family}: routing or WUPS differ from "
                             f"ask_batch's")

    line = {"phase": "heatmaps", "family": family, "mode": mode,
            "card": card, "model": SERVED_LAUNCHES[family][1],
            "dtype": "bfloat16 compute, fp32 weights", "batch": BATCH,
            "top_k": HEATMAP_TOP_K, "launches_per_forward": launches,
            "map_shape": list(maps.shape),
            "logprob_diff_vs_ask_batch": logprob_diff,
            "topk_equal_ask_batch": True, "perfect_matches": int(sum(perfect)),
            "average_wups": avg_wups(heat_answers)}
    if mode == "cam":
        spec = FAMILIES.get(family)
        build = spec["build"] if spec else _build_model
        plain = prepare_model(build(torch, torch.float32, False),
                              torch.device(DEVICE), torch.bfloat16)
        plain.load_state_dict(model.state_dict(), strict=True)
        off = step(plain.eval())
        lp_diff = float((out["log_probs"].float()
                         - off["log_probs"].float()).abs().max())
        with torch.inference_mode(), autocast():
            on_f, off_f = (m.compute_vision_features(
                device_batch["image_tensors"]).float()
                for m in (model, plain))
        on_mean, off_mean = on_f.mean(dim=-1), off_f.mean(dim=-1)
        f_scale = float(off_f.abs().max())
        m_scale = float(off_mean.abs().max())
        mean_diff = float((on_mean - off_mean).abs().max())
        cam_diff = float((out["maps"] - off["maps"]).abs().max())
        if not (lp_diff <= LOGPROB_TOL["bfloat16"]
                and mean_diff <= CAM_TOL * f_scale):
            raise AssertionError(
                f"{family} kernels on/off: log-probs {lp_diff} "
                f"(tolerance {LOGPROB_TOL['bfloat16']}), channel-mean CAMs "
                f"{mean_diff / f_scale} of the features' magnitude "
                f"(tolerance {CAM_TOL})")
        line.update({
            "kernels_off_logprob_diff": lp_diff,
            "kernels_off_feature_rel_diff":
                float((on_f - off_f).abs().max()) / f_scale,
            "kernels_off_cam_mean_diff_rel_features": mean_diff / f_scale,
            "kernels_off_cam_mean_diff_rel_mean": mean_diff / m_scale,
            "kernels_off_scaled_cam_diff": cam_diff,
            "cam_mean_share_of_features": m_scale / f_scale,
            "cam_min_range_share_of_mean": float(
                (off_mean.amax(dim=(1, 2)) - off_mean.amin(dim=(1, 2)))
                .min()) / m_scale,
            "logprob_tol": LOGPROB_TOL["bfloat16"], "cam_tol": CAM_TOL})
        del plain, off, on_f, off_f, on_mean, off_mean
    else:
        with torch.inference_mode(), autocast():
            attentions = model(**device_batch, return_attentions=True)[2]
            device_masks = rollout_mask_batch(attentions)
        host_maps = attentions.cpu().numpy()
        host_masks = np.stack([rollout_mask(host_maps[:, b])
                               for b in range(BATCH)])
        mask_diff = float(np.abs(device_masks.cpu().numpy()
                                 - host_masks).max())
        step_diff = float((device_masks - out["maps"]).abs().max())
        if not (mask_diff <= ROLLOUT_TOL and step_diff == 0.0):
            raise AssertionError(f"rollout masks: device against numpy "
                                 f"{mask_diff} (tolerance {ROLLOUT_TOL}), "
                                 f"against the step {step_diff}")
        line.update({"attention_maps": list(attentions.shape),
                     "attention_maps_dtype": str(attentions.dtype),
                     "attention_maps_bytes": attentions.numel()
                     * attentions.element_size(),
                     "rollout_mask_diff": mask_diff,
                     "rollout_tol": ROLLOUT_TOL})
        del attentions, device_masks, host_maps

    # timings: the device step alone (CUDA events, and its kernels' busy
    # time from the profiler), and make_infer_fn's whole call on the host
    # batch (copy in, device step, copy out of the top-k and the maps)
    infer = make_infer_fn(model, mode, HEATMAP_TOP_K, torch.bfloat16)
    host_batch = {k: v for k, v in batch.items()
                  if k not in _EVAL_KEYS and not k.startswith("_")}
    infer(host_batch)
    infer_ms = []
    for _ in range(HEATMAP_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = infer(host_batch)
        infer_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_device(torch, lambda: step(model))
    line.update({
        "device_step_ms": cuda_ms(torch, lambda: step(model),
                                  iters=HEATMAP_ROUNDS, warmup=1),
        "device_busy_ms": prof["busy_ms"],
        "device_step_kernel_launches": prof["launches"],
        "infer_fn_ms_median": float(np.median(infer_ms)),
        "host_bytes_per_batch": int(sum(v.nbytes for v in host.values())),
        "note": "the host step (overlays, PNGs) needs cv2, which this "
                "machine lacks: the CPU tests hold it against JAX's"})
    torch.cuda.empty_cache()
    return line


def phase_heatmaps(torch, card, kept):
    lines = {f: heatmap_family(torch, card, f, *kept[f])
             for f in HEATMAP_MODES}
    for line in lines.values():
        emit(line)
    return {name: {f: line["launches_per_forward"][name]
                   for f, line in lines.items()}
            for name in ("attention", "bottleneck")}


def _http(server, method, path, body=None, raw=None):
    """(status, JSON reply) of one request to ``server``."""
    import urllib.error
    import urllib.request

    url = f"http://{server.host}:{server.port}{path}"
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_family(torch, card, family, session, data):
    """``VQAHTTPServer`` on an ephemeral port over a session served from a
    checkpoint: /healthz, 64 /v1/ask, one /v1/ask_batch of 64, /v1/generate
    and a bad body, against the session's direct calls."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.eval.http_server import VQAHTTPServer
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K

    answers, _, test_ds, load_images = data
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_http_{family}_")
    server = None
    try:
        # the server checks that a request's image_path is a file: empty
        # files stand in, and their images are the seeded ones
        requests = []
        for s in test_ds[:BATCH]:
            path = os.path.join(tmp, s.image_path)
            open(path, "wb").close()
            requests.append((path, s.question.question_text))
        stub = lambda paths: load_images([os.path.basename(p)
                                          for p in paths])
        server = VQAHTTPServer(session, port=0).start()
        bodies = [{"image_path": p, "question": q, "top_k": 3}
                  for p, q in requests]
        with seeded_images(stub):
            session.ask_batch(requests[:1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            direct = session.ask_batch(requests, top_k=3)
            direct_s = time.perf_counter() - t0
            A.launches = 0
            K.launches = 0
            routes = route_counts(A)
            status, health = _http(server, "GET", "/healthz")
            t0 = time.perf_counter()
            singles = [_http(server, "POST", "/v1/ask", b) for b in bodies]
            singles_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            batch_status, batched = _http(
                server, "POST", "/v1/ask_batch",
                {"requests": [{"image_path": p, "question": q}
                              for p, q in requests], "top_k": 3})
            batch_s = time.perf_counter() - t0
            launches = {"attention": A.launches, "bottleneck": K.launches}
            routes = routes_since(A, routes)
            generated = {}
            body = {"image_path": requests[0][0], "question": requests[0][1],
                    "max_answer_length": GEN_TOKENS}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for beams in (1, GEN_BEAMS):
                    generated[beams] = (
                        _http(server, "POST", "/v1/generate",
                              dict(body, num_beams=beams)),
                        session.generate(*requests[0], num_beams=beams,
                                         max_answer_length=GEN_TOKENS)
                        if family == "vit" else None)
            bad = _http(server, "POST", "/v1/ask", raw=b"{not json")
        if status != 200 or health["family"] != session.family or \
                health["batch_size"] != BATCH or \
                health["answer_space_size"] != ANSWERS:
            raise AssertionError(f"/healthz: {status} {health}")
        if bad != (400, {"error": "body is not JSON"}):
            raise AssertionError(f"a bad body got {bad}")
        per_forward = SERVED_LAUNCHES[family][0]
        want = {"attention": per_forward[0] * (BATCH + 1),
                "bottleneck": per_forward[1] * (BATCH + 1)}
        if launches != want:
            raise AssertionError(f"{family} launches over 64 asks and one "
                                 f"ask_batch {launches}, expected {want}")
        check_routes(f"{family} over HTTP", routes,
                     {SERVED_ROUTES[family]: want["attention"]})
        if any(st != 200 for st, _ in singles) or batch_status != 200:
            raise AssertionError(f"{family}: HTTP statuses "
                                 f"{[st for st, _ in singles]} {batch_status}")
        prob_diff = 0.0
        for got in ([r for _, r in singles], batched["results"]):
            for g, d in zip(got, direct):
                if g["answer"] != d["answer"]:
                    raise AssertionError(f"{family}: HTTP answer "
                                         f"{g['answer']!r} against "
                                         f"{d['answer']!r}")
                prob_diff = max(prob_diff, float(np.abs(
                    np.asarray(g["top_probs"]) - d["top_probs"]).max()))
        if not prob_diff <= LOGPROB_TOL["bfloat16"]:
            raise AssertionError(f"{family}: HTTP probabilities {prob_diff} "
                                 f"from the direct call's")
        for beams, ((st, got), want_gen) in generated.items():
            if family == "vit":
                if st != 200 or got["token_ids"] != want_gen["token_ids"]:
                    raise AssertionError(f"/v1/generate ({beams} beams): "
                                         f"{st} {got} against {want_gen}")
            elif st != 400 or "generate_batch needs the ViT" not in \
                    got["error"]:
                raise AssertionError(f"/v1/generate on {family}: {st} {got}")
        return {"phase": "http", "family": family, "card": card,
                "model": SERVED_LAUNCHES[family][1], "batch": BATCH,
                "requests": len(requests), "launches": launches,
                "healthz": health,
                "ask_requests_per_s": len(requests) / singles_s,
                "ask_batch_pairs_per_s": len(requests) / batch_s,
                "direct_ask_batch_pairs_per_s": len(requests) / direct_s,
                "http_prob_max_abs_diff": prob_diff,
                "prob_tol": LOGPROB_TOL["bfloat16"],
                "generate": {str(b): g[0][0] for b, g in generated.items()},
                "bad_body": bad[0],
                "note": "image_b64 decoding is not exercised: the card's "
                        "machine has no decoder, the images are stubbed"}
    finally:
        if server is not None:
            server.close()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_http(torch, card, kept):
    lines = {f: http_family(torch, card, f, *kept[f]) for f in HTTP_FAMILIES}
    for line in lines.values():
        emit(line)
    return {name: {f: line["launches"][name] for f, line in lines.items()}
            for name in ("attention", "bottleneck")}


def okvqa_corpus(root):
    """COCO-style question and annotation JSONs for both splits under
    ``root``, each question with a 10-answer annotator grid over the answer
    space, and empty image files under COCO's names (the dataset lists the
    directory; seeded images stand in for the pixels). Returns (answers,
    load_images)."""
    from t5_resnet_vqa_torch.core import constants

    answers = [f"answer{i:03d}" for i in range(ANSWERS)]
    qtypes = list(constants.QUESTION_TYPES)
    rng = np.random.default_rng(4)
    images = {}
    counts = {"train": OKVQA_TRAIN_BATCHES * BATCH,
              "val": OKVQA_TEST_BATCHES * BATCH}
    for split, base in (("train", 100000), ("val", 200000)):
        image_dir = os.path.join(root, f"{split}2014")
        os.makedirs(image_dir)
        ids = [base + i for i in range(OKVQA_IMAGES[split])]
        for image_id in ids:
            path = os.path.join(image_dir,
                                f"COCO_{split}2014_{image_id:012d}.png")
            open(path, "wb").close()
            images[path] = rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                        dtype=np.uint8)
        questions, annotations = [], []
        for i in range(counts[split]):
            qid = base * 10 + i
            image_id = ids[i % len(ids)]
            votes = ([answers[int(rng.integers(ANSWERS))]] * 7
                     + [answers[int(rng.integers(ANSWERS))]
                        for _ in range(3)])
            questions.append({"question": f"what is on the table {i % 17}",
                              "question_id": qid, "image_id": image_id})
            annotations.append({
                "question_id": qid, "image_id": image_id,
                "question_type": qtypes[int(rng.integers(len(qtypes)))],
                "answer_type": "other",
                "answers": [{"answer": v, "answer_confidence": "yes",
                             "answer_id": k + 1}
                            for k, v in enumerate(votes)]})
        name = "train" if split == "train" else "val"
        with open(os.path.join(
                root, f"OpenEnded_mscoco_{name}2014_questions.json"),
                "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(root, f"mscoco_{name}2014_annotations.json"),
                  "w") as f:
            json.dump({"annotations": annotations}, f)

    def load_images(paths):
        return np.stack([images[p] for p in paths])

    return answers, load_images


def phase_okvqa(torch, card):
    """The CNN family trains on OK-VQA: ``dataset_type="okvqa"``, the
    reference config (production dropout, the cache on, bf16), 4 train and
    1 test batch of 64. Returns the launches, the trained model, a cached
    train batch and the config, which the optimizer phase reuses."""
    import shutil
    import tempfile

    from t5_resnet_vqa_torch.data import DataLoader, OkVqaTrainableDataset
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import VQATrainer
    from t5_resnet_vqa_torch.train.trainer import build_collates

    tmp = tempfile.mkdtemp(prefix="chip_smoke_okvqa_")
    try:
        root = os.path.join(tmp, "okvqa")
        os.makedirs(root)
        answers, load_images = okvqa_corpus(root)
        cfg = train_config(os.path.join(tmp, "out"))
        cfg.dataset.dataset_type = "okvqa"
        cfg.dataset.root_data_dir = root
        calls = {"train": [], "eval": []}
        labels = []

        def counted(kind, fn):
            def run(batch):
                a0, k0 = A.launches, K.launches
                if kind == "train":
                    labels.append(batch["annotation_ids"].cpu().numpy())
                out = fn(batch)
                calls[kind].append((A.launches - a0, K.launches - k0,
                                    out[0]))
                return out
            return run

        A.launches = 0
        K.launches = 0
        t0 = time.perf_counter()
        with seeded_images(load_images):
            trainer = VQATrainer(_build_model(torch, torch.float32, True),
                                 cfg, answers)
            cache_build = (A.launches, K.launches)
            trainer.train_step = counted("train", trainer.train_step)
            trainer.eval_step = counted("eval", trainer.eval_step)
            trainer.train()
        epoch_s = time.perf_counter() - t0
        launches = {"attention": A.launches, "bottleneck": K.launches}
        counts = {"cache_build": cache_build,
                  "train": [c[:2] for c in calls["train"]],
                  "eval": [c[:2] for c in calls["eval"]]}
        want = {"cache_build": OKVQA_LAUNCHES["cache_build"],
                "train": [OKVQA_LAUNCHES["train"]] * OKVQA_TRAIN_BATCHES,
                "eval": [OKVQA_LAUNCHES["eval"]] * OKVQA_TEST_BATCHES}
        if counts != want:
            raise AssertionError(f"OK-VQA launches (attention, bottleneck) "
                                 f"{counts}, expected {want}")
        losses = [float(c[2]) for c in calls["train"]]
        if not np.isfinite(losses).all():
            raise AssertionError(f"OK-VQA losses {losses}")
        with open(trainer.logger.log_path) as f:
            log = f.read()
        n_train, n_val = (OKVQA_TRAIN_BATCHES * BATCH,
                          OKVQA_TEST_BATCHES * BATCH)
        for line in (f"Dataset: OK-VQA (COCO-style), {n_train} train / "
                     f"{n_val} val questions, 10-annotator-answer grid -> "
                     f"fresh-answer sampling",
                     f"Frozen-feature cache: {sum(OKVQA_IMAGES.values())} "
                     f"images", "Average WUPS Score"):
            if line not in log:
                raise AssertionError(f"the OK-VQA log lacks {line!r}")

        # the labels the steps took: the CPU collate's for the same seed,
        # each one of its question's 10 annotator answers
        dk = cfg.dataset
        dataset = OkVqaTrainableDataset.from_files(
            dk.root_data_dir, dk.train_annotations_json_fn,
            dk.train_questions_json_fn, dk.train_images_dir, "train")
        collate, _ = build_collates(dk, answers, cfg.trainer.seed)
        collate.emit_images = False
        replay = list(DataLoader(dataset, collate, BATCH, shuffle=True,
                                 seed=cfg.trainer.seed))
        for got, cpu in zip(labels, replay):
            if not np.array_equal(got, cpu["annotation_ids"]):
                raise AssertionError("the card's OK-VQA labels differ from "
                                     "the CPU collate's")
            for label, row in zip(got, cpu["_indices"]):
                if answers[int(label)] not in \
                        dataset[int(row)].annotation.answers:
                    raise AssertionError("a label outside its question's "
                                         "annotator grid")
        batch = first_batch(torch, trainer.train_dataloader)
        model = trainer.model
        del trainer
        emit({"phase": "okvqa", "card": card,
              "model": "resnet50 + t5-base + 3xSGA", "answers": ANSWERS,
              "dtype": "bfloat16 compute, fp32 master weights",
              "dropout": "production (T5 0.1, SGA 0.1)", "batch": BATCH,
              "train_steps": OKVQA_TRAIN_BATCHES,
              "eval_forwards": OKVQA_TEST_BATCHES,
              "questions": {"train": n_train, "val": n_val},
              "images": OKVQA_IMAGES, "launches": launches,
              "launches_cache_build": dict(zip(("attention", "bottleneck"),
                                               cache_build)),
              "losses": losses, "epoch_s": epoch_s,
              "labels_equal_cpu_collate": True,
              "note": "COCO-style JSONs written by the phase; empty image "
                      "files, seeded pixels"})
        return launches, (model, batch, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cpu_tree(torch, tree):
    """A copy of a state_dict tree on the host (tensors copied, even those
    already there)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(torch, v) for v in tree]
    return tree


def optimizer_steps(torch, model, batch, cfg, opt_type, kwargs):
    """OPT_STEPS steps of ``opt_type`` at dropout 0 (the model in eval mode)
    on ``batch`` repeated, every group at OPT_LR: the losses, and per step
    the relative L2 gap of the card's update from the same optimizer stepped
    on CPU copies of the step's parameters, clipped gradients and state
    (over all tensors, and the farthest tensor)."""
    from t5_resnet_vqa_torch.train import build_optimizer

    cfg = parity_config(cfg)
    cfg.optimizer.type = opt_type
    cfg.optimizer.kwargs = dict(kwargs)
    for key in ("default_lr", "lm_encoder_lr", "lm_decoder_lr", "vision_lr",
                "classifier_lr", "fusion_lr"):
        setattr(cfg.optimizer, key, OPT_LR)
    optimizer, scheduler, _, trainable = build_optimizer(
        model, cfg.optimizer, cfg.lr_scheduler, OPT_STEPS,
        frozen_modules=model.frozen_modules())
    groups = [len(g["params"]) for g in optimizer.param_groups]
    names = {id(p): n for n, p in model.named_parameters()}
    model.eval()
    losses, gaps, worst = [], [], []
    for _ in range(OPT_STEPS):
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(DEVICE, dtype=torch.bfloat16):
            loss = model(**batch)[1]
        loss.backward()
        torch.nn.utils.clip_grad_norm_(trainable,
                                       cfg.trainer.gradient_clipping)
        before = [p.detach().to("cpu", copy=True) for p in trainable]
        cpu_params = [b.clone() for b in before]
        for c, p in zip(cpu_params, trainable):
            c.grad = p.grad.detach().to("cpu", copy=True)
        cpu_groups, i = [], 0
        for n in groups:
            cpu_groups.append({"params": cpu_params[i:i + n]})
            i += n
        reference = type(optimizer)(cpu_groups, lr=0.0)
        reference.load_state_dict(_cpu_tree(torch, optimizer.state_dict()))
        optimizer.step()
        scheduler.step()
        reference.step()
        losses.append(float(loss.detach()))
        num = den = 0.0
        per_tensor = []
        for p, b, c in zip(trainable, before, cpu_params):
            card = p.detach().cpu() - b
            want = c - b
            d = float((card - want).double().square().sum())
            w = float(want.double().square().sum())
            num, den = num + d, den + w
            per_tensor.append(((d / max(w, 1e-300)) ** 0.5, names[id(p)]))
        gaps.append((num / den) ** 0.5)
        worst.append(max(per_tensor))
    model.train()
    return losses, gaps, worst, sum(p.numel() for p in trainable)


def phase_optimizers(torch, card, model, batch, cfg):
    """SGD (momentum 0.9), Lamb (weight decay 0.1) and Adafactor on the CNN
    family's cached step (B=64, bf16 compute, fp32 master weights), each
    from the same weights: OPT_STEPS steps at dropout 0 on a repeated batch
    at OPT_LR (the loss must fall; the card's update within OPT_TOL of the
    CPU's),
    then step times of each beside AdamW(amsgrad) of the reference config,
    in turns, at production dropout."""
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.train import build_optimizer, make_train_step

    start = {k: v.clone() for k, v in model.state_dict().items()}
    results = {}
    for opt_type, kwargs in OPTIMIZERS.items():
        model.load_state_dict(start)
        a0, k0 = A.launches, K.launches
        losses, gaps, worst, n = optimizer_steps(torch, model, batch, cfg,
                                                 opt_type, kwargs)
        launches = {"attention": (A.launches - a0) // OPT_STEPS,
                    "bottleneck": (K.launches - k0) // OPT_STEPS}
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{opt_type}: losses {losses} on a "
                                 f"repeated batch")
        if not max(gaps) <= OPT_TOL:
            raise AssertionError(f"{opt_type}: the card's update is "
                                 f"{max(gaps)} from the CPU's (tolerance "
                                 f"{OPT_TOL}); per step the tensor "
                                 f"farthest from it: {worst}")
        results[opt_type] = {"kwargs": kwargs, "losses": losses,
                             "update_rel_l2_vs_cpu": gaps,
                             "worst_tensor_rel_l2_vs_cpu": worst,
                             "launches_per_step_dropout_0": launches,
                             "trainable_parameters": n}

    steps = {}
    for opt_type, kwargs in {"AdamW": dict(cfg.optimizer.kwargs),
                             **OPTIMIZERS}.items():
        c = parity_config(cfg)
        c.optimizer.type = opt_type
        c.optimizer.kwargs = dict(kwargs)
        optimizer, scheduler, _, trainable = build_optimizer(
            model, c.optimizer, c.lr_scheduler, 10000,
            frozen_modules=model.frozen_modules())
        step = make_train_step(model, optimizer, scheduler, trainable,
                               c.trainer.gradient_clipping, torch.bfloat16)
        steps[opt_type] = lambda step=step: float(step(batch)[0])
        steps[opt_type]()
    model.train()
    times = {t: [] for t in steps}
    for r in range(OPT_ROUNDS):
        for t in (list(steps) if r % 2 == 0 else list(steps)[::-1]):
            times[t].append(step_ms(torch, steps[t]))
    for t, ms in times.items():
        results.setdefault(t, {"kwargs": dict(cfg.optimizer.kwargs)})
        results[t].update({"train_step_ms": float(np.median(ms)),
                           "steps_ms": ms})
    model.load_state_dict(start)
    emit({"phase": "optimizers", "card": card,
          "model": "resnet50 + t5-base + 3xSGA (cached features)",
          "dtype": "bfloat16 compute, fp32 master weights", "batch": BATCH,
          "steps": OPT_STEPS, "tol": OPT_TOL,
          "timing": "production dropout, in turns, median of "
                    f"{OPT_ROUNDS}",
          "optimizers": results})
    return results


# ------------------------------------------------------------------ mesh

MESH_RANKS = 4
MESH_STEPS = 3
MESH_SHAPES = [(2, 1), (1, 2), (2, 2)]
MESH_FP32_SHAPES = [(2, 2)]        # the fp32 gate's shape
MESH_SERVE_SHAPES = [(1, 2), (2, 1)]
# production dropout: the step's peak memory per rank on one device and 2x2
MESH_DROPOUT_SHAPES = [(1, 1), (2, 2)]
MESH_TRAINER_SHAPE = (2, 2)
MESH_TRAINER_BATCHES = (2, 1)      # train and test batches of its epoch
# the update's L2 on a mesh against one device, relative: bf16 the train
# gate (LOGPROB_TOL), fp32 sums in another order
MESH_UPDATE_TOL = {"bfloat16": LOGPROB_TOL["bfloat16"], "float32": 1e-4}
# a collective or a rendezvous may wait this long for the ranks that run a
# smaller mesh before it (one process per rank, all on one card)
MESH_TIMEOUT_S = 900


def _shape_name(shape):
    return f"{shape[0]}x{shape[1]}"


def mesh_train(torch, cfg, batches, mesh, dtype, dropout=False):
    """MESH_STEPS steps of the CNN family at full width on ``mesh`` through
    the trainer's own setup (``setup_train_step``: the model split over the
    model axis, its frozen parameters out of the gradient, DDP over the
    data axis, the clip and AdamW over the full tensors), each rank on its
    rows of the global batches; ``dropout`` at the production rates.
    Returns (model, record); the record holds the device memory this
    rank's process allocated in the last step above what it held before
    (``last_step_peak_mib``)."""
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.parallel import sharding as shd
    from t5_resnet_vqa_torch.parallel.tensor_parallel import tp_dim
    from t5_resnet_vqa_torch.train.trainer import (
        prepare_model,
        setup_train_step,
    )

    torch.manual_seed(0)
    model = prepare_model(_build_model(torch, torch.float32, True,
                                       dropout=dropout), mesh.device, dtype)
    _, _, _, step = setup_train_step(model, cfg, MESH_STEPS, dtype, mesh)
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    rows = mesh.batch_rows(BATCH)
    losses, counts, routes, times = [], [], [], []
    for i, batch in enumerate(batches):
        local = {k: v[rows] for k, v in batch.items()}
        torch.cuda.synchronize()
        if i == len(batches) - 1:
            torch.cuda.reset_peak_memory_stats(mesh.device)
            held = torch.cuda.memory_allocated(mesh.device)
        t0 = time.perf_counter()
        a0, k0, r0 = A.launches, K.launches, route_counts(A)
        loss, _ = step(local)
        loss = float(shd.mean_over_data(loss.detach().float(), mesh))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append([A.launches - a0, K.launches - k0])
        routes.append(routes_since(A, r0))
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated(mesh.device) - held
    named = dict(model.named_parameters())
    split = [float((named[n] - p0).double().square().sum())
             for n, p0 in before.items() if tp_dim(named[n]) is not None]
    whole = [float((named[n] - p0).double().square().sum())
             for n, p0 in before.items() if tp_dim(named[n]) is None]
    sq = sum(whole)
    if split:
        sq += float(shd.all_reduce_sum(
            torch.tensor(sum(split), dtype=torch.float64,
                         device=mesh.device), mesh.tp_group))
    q_rows = model.sga_modules[0].mhatt1.linear_q.weight.shape[0]
    record = {"losses": losses, "launches_per_step": counts,
              "routes_per_step": routes,
              "step_ms": times, "update_l2": sq ** 0.5,
              "last_step_peak_mib": peak / 2 ** 20,
              "sga_heads": q_rows // 96, "rows": rows.stop - rows.start}
    return model, record


def _full_trainable(torch, model, mesh):
    """The trainable parameters of a mesh rank's model, gathered whole."""
    from t5_resnet_vqa_torch.parallel import sharding as shd
    return shd.gather_state_dict(
        {n: p.detach() for n, p in model.named_parameters()
         if p.requires_grad}, mesh)


def mesh_trainer(torch, rank, out_dir):
    """One epoch of ``VQATrainer`` (the CNN family at full width, bf16,
    dropout 0, the cache on; MESH_TRAINER_BATCHES) without a mesh on rank 0,
    then on the 2x2 mesh on every rank, its steps and eval forwards
    counted. The mesh trainer runs its own mesh branches: the loaders give
    each rank its rows, the cache stays on the host in pinned memory, the
    losses are averaged and the predictions gathered over the data axis,
    rank 0 scores and writes ``best-model.pt`` and the recovery pair
    (gathered whole). Then a 2x2 session over its gathered weights serves
    the test requests in fp32. Returns this rank's records (rank 0 also the
    mesh-free trainer's and the served log-probs)."""
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.parallel import make_mesh
    from t5_resnet_vqa_torch.parallel import sharding as shd
    from t5_resnet_vqa_torch.train import VQATrainer

    answers, train_ds, test_ds, load_images = data = train_data(
        *MESH_TRAINER_BATCHES)

    def run(mesh, sub):
        cfg = parity_config(train_config(os.path.join(out_dir, sub)))
        calls = {"train": [], "eval": []}

        def counted(kind, fn):
            def step(batch):
                a0, k0, r0 = A.launches, K.launches, route_counts(A)
                out = fn(batch)
                calls[kind].append([A.launches - a0, K.launches - k0,
                                    out[0], routes_since(A, r0)])
                return out
            return step

        with seeded_images(load_images):
            a0, k0 = A.launches, K.launches
            trainer = VQATrainer(
                _build_model(torch, torch.float32, True, dropout=False),
                cfg, answers, train_ds, test_ds, mesh=mesh)
            build = [A.launches - a0, K.launches - k0]
            trainer.train_step = counted("train", trainer.train_step)
            trainer.eval_step = counted("eval", trainer.eval_step)
            t0 = time.perf_counter()
            trainer.train()
            epoch_s = time.perf_counter() - t0
        losses = torch.stack([c[2] for c in calls["train"]]).float()
        if mesh is not None:
            losses = shd.mean_over_data(losses, mesh)
        cache = trainer._feature_cache
        rec = {"launches_cache_build": build,
               "launches_per_train_step": [c[:2] for c in calls["train"]],
               "launches_per_eval_forward": [c[:2] for c in calls["eval"]],
               "routes": [c[3] for c in calls["train"] + calls["eval"]],
               "losses": losses.cpu().tolist(), "epoch_s": epoch_s,
               "cache_pinned": cache is not None and
               cache.features.is_pinned()}
        if rank == 0:
            with open(trainer.logger.log_path) as f:
                rec["log"] = f.read()
            with open(os.path.join(cfg.trainer.output_dir,
                                   "validation_predictions",
                                   "0_validation_predictions.json")) as f:
                rec["validation_predictions"] = len(json.load(f))
        return trainer, rec

    out = {"cache_chunks": cache_chunks(data)}
    if rank == 0:
        trainer, out["one"] = run(None, "one")
        del trainer
        torch.cuda.empty_cache()
    mesh = make_mesh(*MESH_TRAINER_SHAPE)
    trainer, out["mesh"] = run(mesh, "mesh")
    full = trainer._full_state_dict(trainer.model)
    del trainer
    torch.cuda.empty_cache()
    session = VQAInferenceSession(
        _build_model(torch, torch.float32, True, dropout=False), full,
        answers, "cnn", batch_size=BATCH, image_size=IMAGE, device=DEVICE,
        mesh=mesh)
    session.collate.load_images = load_images
    requests = [(test_ds[i].image_path, test_ds[i].question.question_text)
                for i in range(BATCH)]
    log_probs = session._gather(session._dispatch_chunk(requests))
    if rank == 0:
        out["served_log_probs"] = log_probs.float().cpu().numpy()
    del session, full
    torch.cuda.empty_cache()
    return out


def mesh_serve_vit(torch, rank):
    """The ViT family's sessions at full width on one device and on the
    MESH_SERVE_SHAPES meshes, in bf16 and fp32: ``ask_batch`` on BATCH
    requests ((attention, bottleneck) launches counted), the gathered
    log-probs and
    greedy ``generate_batch`` tokens."""
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.parallel import make_mesh

    rng = np.random.default_rng(5)
    answers = [f"answer{i:03d}" for i in range(ANSWERS)]
    requests = [(f"mesh_vit_{i}.png", f"what is on the table number {i}")
                for i in range(BATCH)]
    images = {path: rng.integers(0, 256, (VIT_IMAGE, VIT_IMAGE, 3),
                                 dtype=np.uint8) for path, _ in requests}

    def load_images(paths):
        return np.stack([images[p] for p in paths])

    out = {}
    for dtype_name in ("bfloat16", "float32"):
        for shape in [(1, 1)] + MESH_SERVE_SHAPES:
            mesh = make_mesh(*shape)
            if not mesh.member:
                continue
            session = VQAInferenceSession(
                _build_vit_model(torch, torch.float32, True), None, answers,
                "vit", batch_size=BATCH, device=DEVICE, mesh=mesh,
                compute_dtype=getattr(torch, dtype_name))
            session.collate.load_images = load_images
            session.ask_batch(requests)           # allocator, cuDNN
            torch.cuda.synchronize()
            a0, k0, r0 = A.launches, K.launches, route_counts(A)
            t0 = time.perf_counter()
            results = session.ask_batch(requests)
            ask_ms = (time.perf_counter() - t0) * 1e3
            launches = [A.launches - a0, K.launches - k0]
            routes = routes_since(A, r0)
            log_probs = session._gather(session._dispatch_chunk(requests))
            tokens = _padded_tokens(_generate(session, requests, 1))
            top1 = [r["answer"] for r in results]
            out[f"{dtype_name}_{_shape_name(shape)}"] = {
                "launches_per_forward": launches,
                "routes_per_forward": routes, "ask_ms": ask_ms,
                "vit_heads": session.model.vision_model.encoder.layer[0]
                .attention.attention.query.weight.shape[0] // 64,
                "log_probs": log_probs.float().cpu().numpy()
                if rank == 0 else None,
                "tokens": tokens if rank == 0 else None,
                "top1": top1 if rank == 0 else None}
            del session
            torch.cuda.empty_cache()
    return out


def mesh_rank(rank, out_dir, nccl=False):
    """One rank of the mesh phase (``parallel.launch.spawn`` runs it in a
    process of its own). The CNN family's train steps on one device and on
    each mesh (bf16; fp32 on MESH_FP32_SHAPES; at production dropout on
    MESH_DROPOUT_SHAPES), ``mesh_trainer``, then the ViT family's serving;
    with ``nccl`` only the bf16 steps at (1, 1) and (2, 1). Rank 0 keeps
    the one-device run's parameters to hold each mesh's against them."""
    import torch
    from t5_resnet_vqa_torch.parallel import make_mesh
    from t5_resnet_vqa_torch.train.trainer import _device_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = train_data(MESH_STEPS, 1)
    cfg = parity_config(train_config(out_dir))
    batches = [_device_batch(r) for r in raw_batches(
        torch, cfg, data, "cnn", MESH_STEPS)]
    out = {"train": {}, "rank": rank}
    runs = ([("bfloat16", [(1, 1), (2, 1)], False)] if nccl else
            [("bfloat16", [(1, 1)] + MESH_SHAPES, False),
             ("float32", [(1, 1)] + MESH_FP32_SHAPES, False),
             ("bfloat16", MESH_DROPOUT_SHAPES, True)])
    for dtype_name, shapes, dropout in runs:
        dtype = getattr(torch, dtype_name)
        one = None
        for shape in shapes:
            mesh = make_mesh(*shape)
            if not mesh.member:
                continue
            model, rec = mesh_train(torch, cfg, batches, mesh, dtype,
                                    dropout)
            key = f"{dtype_name}_{_shape_name(shape)}"
            if dropout:
                out["train"][f"{key}_dropout"] = rec
                del model
                torch.cuda.empty_cache()
                continue
            full = _full_trainable(torch, model, mesh)
            if shape == (1, 1):
                one = full
            elif rank == 0:
                num = sum(float((full[n] - one[n]).double().square().sum())
                          for n in one)
                rec["param_diff_l2"] = num ** 0.5
            out["train"][key] = rec
            del model, full
            torch.cuda.empty_cache()
        del one
    if not nccl:
        out["trainer"] = mesh_trainer(torch, rank, out_dir)
        out["serve_vit"] = mesh_serve_vit(torch, rank)
    return out


def _check_mesh_train(results, one_key, shapes, dtype_name):
    """Every rank's steps on each mesh against rank 0's one-device run:
    launches (6 attention at H/tp, 7 bottleneck per step at B/dp), losses
    and the update's L2 within the gates."""
    one = results[0]["train"][one_key]
    route = "short_kv" if dtype_name == "bfloat16" else "fp32"
    if one["launches_per_step"] != [[6, 7]] * MESH_STEPS or \
            one["routes_per_step"] != [{route: 6}] * MESH_STEPS:
        raise AssertionError(f"{one_key}: launches "
                             f"{one['launches_per_step']} per step, routes "
                             f"{one['routes_per_step']}")
    line = {}
    for shape in shapes:
        key = f"{dtype_name}_{_shape_name(shape)}"
        dp, tp = shape
        ranks = [r["train"][key] for r in results if key in r["train"]]
        if len(ranks) != dp * tp:
            raise AssertionError(f"{key}: {len(ranks)} ranks ran")
        for rec in ranks:
            if rec["launches_per_step"] != one["launches_per_step"] or \
                    rec["routes_per_step"] != one["routes_per_step"] or \
                    rec["sga_heads"] != 8 // tp or \
                    rec["rows"] != BATCH // dp:
                raise AssertionError(
                    f"{key}: launches {rec['launches_per_step']} per step, "
                    f"routes {rec['routes_per_step']}, {rec['sga_heads']} "
                    f"SGA heads, {rec['rows']} rows")
        rec = ranks[0]
        if dtype_name == "bfloat16":
            loss_diff = max(abs(a - b) for a, b in
                            zip(rec["losses"], one["losses"]))
        else:
            loss_diff = max(abs(a - b) / abs(b) for a, b in
                            zip(rec["losses"], one["losses"]))
        update_diff = abs(rec["update_l2"] - one["update_l2"]) / \
            one["update_l2"]
        # the parameters' difference over the update: fp32 gates it as the
        # train phase's kernels on/off (UPDATE_TOL); a wrong split moves a
        # whole share of the update, which loss and update norm at random
        # weights barely show
        ratio = rec["param_diff_l2"] / one["update_l2"]
        tol = TRAIN_LOSS_TOL[dtype_name]
        if not (loss_diff <= tol and
                update_diff <= MESH_UPDATE_TOL[dtype_name] and
                (dtype_name != "float32" or ratio <= UPDATE_TOL)):
            raise AssertionError(
                f"{key}: losses {rec['losses']} against {one['losses']} "
                f"(differ by {loss_diff} > {tol}?), update L2 "
                f"{rec['update_l2']} against {one['update_l2']} (differ by "
                f"{update_diff} > {MESH_UPDATE_TOL[dtype_name]}?), "
                f"parameters differ by {ratio} of the update")
        line[key] = {"losses": rec["losses"], "loss_diff": loss_diff,
                     "loss_tol": tol, "update_l2": rec["update_l2"],
                     "update_l2_diff": update_diff,
                     "update_tol": MESH_UPDATE_TOL[dtype_name],
                     "param_diff_over_update": ratio,
                     "step_ms": rec["step_ms"],
                     "last_step_peak_mib": rec["last_step_peak_mib"],
                     "launches_per_step_per_rank":
                         rec["launches_per_step"][0]}
    line[one_key] = {"losses": one["losses"], "update_l2": one["update_l2"],
                     "step_ms": one["step_ms"],
                     "last_step_peak_mib": one["last_step_peak_mib"]}
    return line


def _check_mesh_dropout(results):
    """The production-dropout steps (MESH_DROPOUT_SHAPES): finite losses and
    per rank the one-device run's launches; each rank's last-step peak
    memory for the line. On the card the mesh's masks are not the
    one-device run's, so the losses are not compared."""
    line = {}
    one = None
    for shape in MESH_DROPOUT_SHAPES:
        key = f"bfloat16_{_shape_name(shape)}_dropout"
        ranks = [r["train"][key] for r in results if key in r["train"]]
        one = one or ranks[0]
        if len(ranks) != shape[0] * shape[1] or any(
                not np.isfinite(rec["losses"]).all() or
                rec["launches_per_step"] != one["launches_per_step"] or
                rec["routes_per_step"] != one["routes_per_step"] or
                any("mma_sync" in r for r in rec["routes_per_step"])
                for rec in ranks):
            raise AssertionError(f"{key}: {ranks}")
        line[key] = {"losses": ranks[0]["losses"],
                     "step_ms": ranks[0]["step_ms"],
                     "launches_per_step_per_rank":
                         ranks[0]["launches_per_step"][0],
                     "last_step_peak_mib_per_rank":
                         [rec["last_step_peak_mib"] for rec in ranks]}
    return line


def _check_mesh_trainer(results):
    """``mesh_trainer``: every rank of the 2x2 trainer launched per cache
    build, train step and eval forward what the mesh-free trainer did, its
    cache pinned on the host; the losses (averaged over the data axis)
    within the bf16 train gate of the mesh-free trainer's; rank 0's log and
    gathered validation predictions."""
    one = results[0]["trainer"]["one"]
    chunks = results[0]["trainer"]["cache_chunks"]
    want = {"launches_cache_build": [0, 7 * chunks],
            "launches_per_train_step": [[6, 0]] * MESH_TRAINER_BATCHES[0],
            "launches_per_eval_forward": [[6, 0]] * MESH_TRAINER_BATCHES[1],
            "routes": [{"short_kv": 6}] * sum(MESH_TRAINER_BATCHES)}
    ranks = [r["trainer"]["mesh"] for r in results]
    for rec in [one] + ranks:
        got = {k: rec[k] for k in want}
        if got != want:
            raise AssertionError(f"trainer launches {got}, expected {want}")
    if one["cache_pinned"] or not all(r["cache_pinned"] for r in ranks):
        raise AssertionError("the mesh trainer's cache is not pinned on the "
                             "host, or the mesh-free one's is")
    mesh = ranks[0]
    diff = max(abs(a - b) for a, b in zip(mesh["losses"], one["losses"]))
    tol = TRAIN_LOSS_TOL["bfloat16"]
    if not diff <= tol:
        raise AssertionError(f"the 2x2 trainer's losses {mesh['losses']} "
                             f"against {one['losses']}: {diff} > {tol}")
    shape = dict(zip(("data", "model"), MESH_TRAINER_SHAPE))
    for text in (f"Mesh: {shape}", "on host (mesh run)",
                 "Average WUPS Score", "Saving new best-model"):
        if text not in mesh["log"]:
            raise AssertionError(f"the 2x2 trainer's log lacks {text!r}")
    if {one["validation_predictions"], mesh["validation_predictions"]} != \
            {MESH_TRAINER_BATCHES[1] * BATCH}:
        raise AssertionError("validation predictions: "
                             f"{one['validation_predictions']} and "
                             f"{mesh['validation_predictions']}")
    cache_line = next(ln for ln in mesh["log"].splitlines()
                      if "Frozen-feature cache:" in ln)
    return {"shape": _shape_name(MESH_TRAINER_SHAPE),
            "train_steps": MESH_TRAINER_BATCHES[0],
            "eval_forwards": MESH_TRAINER_BATCHES[1],
            "losses": mesh["losses"], "one_device_losses": one["losses"],
            "loss_diff": diff, "loss_tol": tol,
            **{k: mesh[k] for k in want},
            "cache_log_line": cache_line,
            "epoch_s": mesh["epoch_s"], "one_device_epoch_s": one["epoch_s"]}


def phase_mesh(torch, card):
    """The (data, model) mesh at full width with gloo on CUDA tensors, every
    rank on this card (see the module docstring). Returns the kernels'
    launches per step and per forward of one rank."""
    import tempfile

    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    from t5_resnet_vqa_torch.parallel import launch

    out_dir = tempfile.mkdtemp(prefix="mesh_phase_")
    t0 = time.perf_counter()
    results = launch.spawn(mesh_rank, MESH_RANKS, (out_dir,),
                           devices=[DEVICE + ":0"] * MESH_RANKS,
                           backend="gloo", timeout_s=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    line = {"phase": "mesh", "card": card,
            "backend": "gloo, every rank on cuda:0 (NCCL refuses two ranks "
                       "on one card)",
            "note": "times with gloo on one card are not a scaling figure",
            "ranks": MESH_RANKS, "steps": MESH_STEPS, "batch": BATCH,
            "spawn_and_run_s": spawn_s}
    line["train"] = _check_mesh_train(results, "bfloat16_1x1", MESH_SHAPES,
                                      "bfloat16")
    line["train"].update(_check_mesh_train(results, "float32_1x1",
                                           MESH_FP32_SHAPES, "float32"))
    line["train_dropout"] = _check_mesh_dropout(results)
    line["trainer"] = _check_mesh_trainer(results)

    # the 2x2 trainer's pair served by a one-device session from the
    # checkpoint
    answers, _, test_ds, load_images = train_data(*MESH_TRAINER_BATCHES)
    requests = [(test_ds[i].image_path, test_ds[i].question.question_text)
                for i in range(BATCH)]
    cfg = train_config(os.path.join(out_dir, "mesh"))
    cfg.model.compute_dtype = "float32"
    with seeded_images(load_images):
        t0 = time.perf_counter()
        session = VQAInferenceSession.from_checkpoint(cfg, batch_size=BATCH,
                                                      device=DEVICE)
        restore_s = time.perf_counter() - t0
        served = session._dispatch_chunk(requests).float().cpu().numpy()
    mesh_lp = results[0]["trainer"]["served_log_probs"]
    err = float(np.abs(served - mesh_lp).max())
    top1 = float((served.argmax(-1) == mesh_lp.argmax(-1)).mean())
    if not (err <= LOGPROB_TOL["float32"] and top1 == 1.0):
        raise AssertionError(f"the 2x2 pair served on one device: log-probs "
                             f"differ by {err}, top-1 agreement {top1}")
    line["served_from_2x2_pair"] = {"max_abs_logprob_diff": err,
                                    "tol": LOGPROB_TOL["float32"],
                                    "top1_agreement": top1,
                                    "from_checkpoint_s": restore_s}
    del session

    # the ViT family's serving on the meshes against one device
    vit = {}
    for dtype_name in ("bfloat16", "float32"):
        one = results[0]["serve_vit"][f"{dtype_name}_1x1"]
        for shape in MESH_SERVE_SHAPES:
            key = f"{dtype_name}_{_shape_name(shape)}"
            ranks = [r["serve_vit"][key] for r in results
                     if key in r["serve_vit"]]
            want_routes = {"wgmma" if dtype_name == "bfloat16" else
                           "fp32": 12}
            if len(ranks) != shape[0] * shape[1] or any(
                    r["launches_per_forward"] != [12, 0] or
                    r["routes_per_forward"] != want_routes or
                    r["vit_heads"] != 12 // shape[1] for r in ranks):
                seen = [(r["launches_per_forward"], r["routes_per_forward"],
                         r["vit_heads"]) for r in ranks]
                raise AssertionError(f"ViT {key}: {len(ranks)} ranks; "
                                     f"launches, routes (expected "
                                     f"{want_routes}) and heads {seen}")
            rec = ranks[0]
            err = float(np.abs(rec["log_probs"] - one["log_probs"]).max())
            same = float((rec["tokens"] == one["tokens"]).all(-1).mean())
            top1 = float(np.mean([a == b for a, b in
                                  zip(rec["top1"], one["top1"])]))
            if not err <= LOGPROB_TOL[dtype_name] or (
                    dtype_name == "float32" and same != 1.0):
                raise AssertionError(
                    f"ViT {key}: log-probs differ by {err} (tol "
                    f"{LOGPROB_TOL[dtype_name]}), greedy tokens equal for "
                    f"{same} of the requests")
            vit[key] = {"max_abs_logprob_diff": err,
                        "tol": LOGPROB_TOL[dtype_name],
                        "greedy_tokens_equal": same, "top1_agreement": top1,
                        "ask_ms": rec["ask_ms"], "one_device_ask_ms":
                            one["ask_ms"],
                        "launches_per_forward_per_rank":
                            rec["launches_per_forward"],
                        "routes_per_forward_per_rank":
                            rec["routes_per_forward"]}
    line["serve_vit"] = vit

    if torch.cuda.device_count() >= 2:
        nccl = launch.spawn(mesh_rank, 2, (out_dir, True),
                            devices=[f"{DEVICE}:0", f"{DEVICE}:1"],
                            backend="nccl", timeout_s=MESH_TIMEOUT_S)
        line["nccl"] = _check_mesh_train(nccl, "bfloat16_1x1", [(2, 1)],
                                         "bfloat16")
    else:
        line["nccl"] = "not run: one card"
    emit(line)
    names = ("attention", "bottleneck")
    return {"train_per_step_per_rank": dict(zip(
                names, results[0]["train"]["bfloat16_2x2"]
                ["launches_per_step"][0])),
            "trainer_per_step_per_rank": dict(zip(
                names, results[0]["trainer"]["mesh"]
                ["launches_per_train_step"][0])),
            "vit_per_forward_per_rank": dict(zip(
                names, results[0]["serve_vit"]["bfloat16_1x2"]
                ["launches_per_forward"])),
            "vit_routes_per_forward_per_rank":
                results[0]["serve_vit"]["bfloat16_1x2"]["routes_per_forward"]}


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

    card = card_line()
    phase_build(torch, card)
    att = phase_attention(torch)
    phase_attention_edges(torch)
    blk = phase_bottleneck(torch)
    # serving forwards write no row statistics
    from t5_resnet_vqa_torch.ops import attention as A
    stats0 = A.stats_launches
    launches = phase_serve(torch, card)
    vit_launches = phase_serve_vit(torch, card)
    family_launches = {f: phase_serve_family(torch, card, f)
                       for f in FAMILIES}
    serve_stats = A.stats_launches - stats0
    if serve_stats:
        raise AssertionError(f"the serving phases' forwards wrote row "
                             f"statistics {serve_stats} times")
    train = phase_train(torch, card)
    train_vit = phase_train_vit(torch, card)
    family_train = {f: phase_train_family(torch, card, f) for f in FAMILIES}
    resumed = phase_resume(torch, card)
    served, kept = phase_serve_from_checkpoint(torch, card)
    heatmap = phase_heatmaps(torch, card, kept)
    http = phase_http(torch, card, kept)
    del kept
    torch.cuda.empty_cache()
    okvqa, (model, batch, cfg) = phase_okvqa(torch, card)
    phase_optimizers(torch, card, model, batch, cfg)
    del model, batch
    torch.cuda.empty_cache()
    mesh = phase_mesh(torch, card)

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
                        "serve_from_checkpoint_launches": served[name],
                        "heatmap_launches": heatmap[name],
                        "http_launches": http[name],
                        "okvqa_train_epoch_launches": okvqa[name],
                        "mesh_train_launches_per_step_per_rank":
                            mesh["train_per_step_per_rank"][name],
                        "mesh_trainer_launches_per_step_per_rank":
                            mesh["trainer_per_step_per_rank"][name],
                        "mesh_vit_launches_per_forward_per_rank":
                            mesh["vit_per_forward_per_rank"][name]})
        for f in FAMILIES:
            kernels[-1].update({
                f"{f}_launches": family_launches[f][name],
                f"{f}_train_epoch_launches": family_train[f]["epoch"][name],
                f"{f}_train_launches_per_step":
                    family_train[f]["per_step"][name]})
    # no one PyTorch call computes the fused block; its cuDNN chain, per
    # forward, stands beside it
    kernels[1]["library_chain_ms"] = blk["library_chain_ms"]
    vit, cross = att["vit"], att["cross"]
    kernels[0].update({
        "route_launches": launches["attention_routes"],
        "vit_route_launches": vit_launches["attention_routes"],
        **{f"{f}_route_launches": family_launches[f]["attention_routes"]
           for f in FAMILIES},
        "mesh_vit_route_launches_per_forward_per_rank":
            mesh["vit_routes_per_forward_per_rank"]})
    kernels[0].update({f"cross_{k}": v for k, v in cross.items()})
    # the SGA's route (short_kv) and, per forward, the mma_sync route's
    # time in the same turns; per launch at each SGA case below
    kernels[0].update({"sga_route": att["route"],
                       "mma_sync_ms": att["mma_sync_ms"]})
    for case in ("sga_sk16", "sga_sk64", "tp2_sga_sk16", "tp2_sga_sk64",
                 "tp2_vit_s197", "tp2_cross_s213"):
        kernels[0].update({f"{case}_{k}": v for k, v in att[case].items()})
    kernels[0].update({"bwd_ms": att["bwd_ms"],
                       "plain_bwd_ms": att["plain_bwd_ms"],
                       "library_bwd_ms": att["library_bwd_ms"],
                       "bwd_bound_ms": att["bwd_bound_ms"],
                       "bwd_max_abs_err": att["bwd_max_abs_err"],
                       "vit_launches": vit_launches["attention"],
                       "vit_route": vit["route"],
                       "vit_ms": vit["ms"],
                       "vit_mma_sync_ms": vit["mma_sync_ms"],
                       "vit_mma_sync_max_abs_err": vit["mma_sync_max_abs_err"],
                       "vit_turns_ms": vit["turns_ms"],
                       "vit_ms_head_views": vit["ms_head_views"],
                       "vit_plain_ms": vit["plain_ms"],
                       "vit_bound_ms": vit["bound_ms"],
                       "vit_bound_by": vit["bound_by"],
                       "vit_library_ms": vit["library_ms"],
                       "vit_max_abs_err": vit["max_abs_err"],
                       **{f"vit_{k}": v for k, v in vit.items()
                          if k.startswith(("bwd", "plain_bwd", "plain_vjp",
                                           "library_bwd", "stats_fwd",
                                           "no_stats_fwd"))}})
    # kernel 1's backward: per launch at the RoBERTa shape, whose 12 layers
    # train in every cross-attention step; its launches are the count over
    # the cross-attention epoch, from 0 just before it
    wgmma_cases = [att[c] for c in ("vit", "cross", "tp2_vit_s197",
                                    "tp2_cross_s213")]
    kernels.append({
        "name": "attention_backward", "route": "cuda",
        "source": "t5_resnet_vqa_torch/csrc/attention_bwd.cu",
        "replaces": "t5_resnet_vqa_tpu/ops/pallas/attention.py:156",
        "launches": family_train["cross"]["epoch_bwd_routes"].get("wgmma", 0),
        "launches_counted_over": f"cross-attention train epoch "
                                 f"({TRAIN_BATCHES} steps)",
        "max_abs_err": max(c["bwd_max_abs_err"] for c in wgmma_cases),
        "ms": cross["bwd_ms"], "plain_ms": cross["plain_vjp_ms"],
        "bound_ms": cross["bwd_bound_ms"],
        "bound_share": cross["bwd_bound_ms"] / cross["bwd_ms"],
        "bound_by": cross["bwd_bound_by"],
        "library_ms": cross["library_bwd_ms"],
        "bwd_vs_library": cross["bwd_vs_library"],
        "shape": [BATCH, 12, CROSS_SEQ, CROSS_SEQ, 64],
        "turns_ms": cross["bwd_turns_ms"],
        "plain_own_backward_ms": cross["plain_bwd_ms"],
        # the training forward that writes the statistics this kernel
        # reads, beside the serving forward in the same turns
        "stats_fwd_ms": cross["stats_fwd_ms"],
        "no_stats_fwd_ms": cross["no_stats_fwd_ms"],
        **{f"{case}_{k}": att[case][key]
           for case in ("vit", "tp2_vit_s197", "tp2_cross_s213")
           for k, key in (("ms", "bwd_ms"), ("plain_ms", "plain_vjp_ms"),
                          ("library_ms", "library_bwd_ms"),
                          ("bound_ms", "bwd_bound_ms"),
                          ("max_abs_err", "bwd_max_abs_err"),
                          ("bwd_vs_library", "bwd_vs_library"),
                          ("stats_fwd_ms", "stats_fwd_ms"),
                          ("no_stats_fwd_ms", "no_stats_fwd_ms"))},
        "cross_train_epoch_stats_launches": family_train["cross"]
        ["epoch_stats"],
        "cross_train_epoch_stats_recomputed": family_train["cross"]
        ["epoch_bwd_stats_recomputed"],
        "serve_stats_launches": serve_stats,
        "cross_train_launches_per_step":
            family_train["cross"]["per_step"]["attention"]
            ["bwd_routes_per_production_step"],
        "vit_fine_tuned_launches_per_step":
            train_vit["per_step"]["attention"]["fine_tuned_bwd_routes"],
        "cnn_dropout_0_launches_per_step":
            train["per_step"]["attention"]["cache_off_dropout_0_bwd_routes"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
