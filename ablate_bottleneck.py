#!/usr/bin/env python3
"""Ablated builds of the bf16 bottleneck kernel, timed against the shipped
one on one NVIDIA GPU (Hopper, sm_90a).

    python3 ablate_bottleneck.py [variant ...]

Each variant is ``t5_resnet_vqa_torch/csrc/bottleneck.cu`` (with
``sm90_common.cuh``) changed by the text substitutions listed for it in
``VARIANTS``, each of which must match the shipped source exactly once.
Every variant is built with ``nvcc -Xptxas -v`` (all at once, by
``kernel_build.build_variants``) into the package's git-ignored
``_build/ablate/``; one JSON line per variant gives ptxas's registers,
spills and serialization warnings per instantiation. A name that is not in
``VARIANTS`` is an error. Then, at the four block shapes of the ResNet-50
stages 0-1 path (bf16, B=64), each variant runs on the same packed
operands as the shipped kernel, in turns (shipped, variant, variant,
shipped): one JSON line per variant and shape with both mean times (CUDA
events over 50 launches after a warm-up, ``chip_smoke.cuda_ms``) and the
variant's error against the plain version relative to max|plain|
(variants may trade speed for nothing else). The card's name and power
limit come first, as ``nvidia-smi`` gives them. Without a CUDA device it
exits with an error.
"""

import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "t5_resnet_vqa_torch", "csrc")
OUT = os.path.join(REPO, "t5_resnet_vqa_torch", "_build", "ablate")
CASES = [    # name, H, Cin, width, stride, downsample
    ("stage0_block0", 64, 64, 64, 1, True),
    ("stage0_block1", 64, 256, 64, 1, False),
    ("stage1_block0", 64, 256, 128, 2, True),
    ("stage1_block1", 32, 512, 128, 1, False),
]
BATCH = 64
ITERS = 50

_CLUSTER_HELPERS = '''__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\\n"
               "barrier.cluster.wait.acquire;\\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned cta) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n"
               : "=r"(remote) : "r"(smem_addr(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n"
               :: "r"(remote) : "memory");
}
__device__ __forceinline__ void bulk_copy_g2s_multicast(void* dst, const void* src,
                                                        unsigned bytes, uint64_t* bar,
                                                        unsigned short cta_mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "h"(cta_mask)
      : "memory");
}

// ---- tensor-map (TMA) copies'''

# Blocks in clusters of two, walking pairs of tiles (a block past the last
# tile takes one of image B: zeros in, nothing out). With ``multicast``,
# each block loads half of every weight entry for both and releases every
# entry to both; without, each loads and releases its own.
def _cluster(multicast: bool):
    subs = [
        ("sm90_common.cuh", "// ---- tensor-map (TMA) copies", _CLUSTER_HELPERS),
        ("bottleneck.cu", "constexpr int kAStages = 2;\n",
         "constexpr int kAStages = 2;\nconstexpr int kCluster = 2;\n"),
        ("bottleneck.cu",
         "  int H, W, Cin, Cw, Cout, Ho, Wo, has_ds, tiles_w, tiles_img, tiles;",
         "  int H, W, Cin, Cw, Cout, Ho, Wo, has_ds, tiles_w, tiles_img, tiles, pairs;"),
        ("bottleneck.cu",
         "  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {\n"
         "    const int b = tile / g.tiles_img, t = tile - b * g.tiles_img;\n"
         "    const int oh0 = (t / g.tiles_w) * C::TH, ow0 = (t % g.tiles_w) * C::TW;\n"
         "    const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;\n"
         "    for (int p = 0;",
         "  for (int pair = blockIdx.x / kCluster; pair < g.pairs;"
         " pair += gridDim.x / kCluster) {\n"
         "    const int tile = pair * kCluster + (int)cluster_ctarank();\n"
         "    const int b = tile / g.tiles_img, t = tile - b * g.tiles_img;\n"
         "    const int oh0 = (t / g.tiles_w) * C::TH, ow0 = (t % g.tiles_w) * C::TW;\n"
         "    const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;\n"
         "    for (int p = 0;"),
        ("bottleneck.cu",
         "  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {\n"
         "    const int b = tile / g.tiles_img, t = tile - b * g.tiles_img;\n"
         "    const int oh0 = (t / g.tiles_w) * C::TH, ow0 = (t % g.tiles_w) * C::TW;\n"
         "    const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;\n\n",
         "  for (int pair = blockIdx.x / kCluster; pair < g.pairs;"
         " pair += gridDim.x / kCluster) {\n"
         "    const int tile = pair * kCluster + (int)cluster_ctarank();\n"
         "    const int b = tile / g.tiles_img, t = tile - b * g.tiles_img;\n"
         "    const int oh0 = (t / g.tiles_w) * C::TH, ow0 = (t % g.tiles_w) * C::TW;\n"
         "    const int ih0 = oh0 * S - 1, iw0 = ow0 * S - 1;\n\n"),
        ("bottleneck.cu", "tile == blockIdx.x) mbar_wait(sm.w2_bar, 0);",
         "pair == blockIdx.x / kCluster) mbar_wait(sm.w2_bar, 0);"),
        ("bottleneck.cu", "  }\n  __syncthreads();\n\n  // one if/else for the roles",
         "  }\n  cluster_sync();\n\n  // one if/else for the roles"),
        ("bottleneck.cu",
         "    if (threadIdx.x == kGroups * 128) produce<S, CW>(sm, &xmap, &dsmap, ops, g);\n",
         "    if (threadIdx.x == kGroups * 128) produce<S, CW>(sm, &xmap, &dsmap, ops, g);\n"
         "    cluster_sync();\n"),
        ("bottleneck.cu", "    consume<S, CW>(sm, &dsmap, &omap, ops, g);\n",
         "    consume<S, CW>(sm, &dsmap, &omap, ops, g);\n    cluster_sync();\n"),
        ("bottleneck.cu",
         "  g.tiles = B * g.tiles_img;\n"
         "  const int grid = g.tiles < num_sms() ? g.tiles : num_sms();\n",
         "  g.tiles = B * g.tiles_img;\n"
         "  g.pairs = (g.tiles + kCluster - 1) / kCluster;\n"
         "  const int pairs_max = num_sms() / kCluster;\n"
         "  const int grid = kCluster * (g.pairs < pairs_max ? g.pairs : pairs_max);\n"),
        ("bottleneck.cu",
         "  bottleneck_bf16<S, CW><<<grid, kThreadsBf16, C::SMEM, stream>>>(xmap, dsmap, omap,\n"
         "                                                                  ops, g);\n"
         "  return (int)cudaGetLastError();",
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cudaLaunchAttribute cl;\n"
         "  cl.id = cudaLaunchAttributeClusterDimension;\n"
         "  cl.val.clusterDim.x = kCluster;\n"
         "  cl.val.clusterDim.y = cl.val.clusterDim.z = 1;\n"
         "  cfg.gridDim = dim3(grid);\n"
         "  cfg.blockDim = dim3(kThreadsBf16);\n"
         "  cfg.dynamicSmemBytes = C::SMEM;\n"
         "  cfg.stream = stream;\n"
         "  cfg.attrs = &cl;\n"
         "  cfg.numAttrs = 1;\n"
         "  const cudaError_t e = cudaLaunchKernelEx(&cfg, bottleneck_bf16<S, CW>, xmap,"
         " dsmap, omap, ops, g);\n"
         "  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();"),
    ]
    if multicast:
        subs += [
            ("bottleneck.cu",
             "    bulk_copy_g2s(sm.ring_w + ws * kWBytes, src, bytes, &sm.full_w[ws]);",
             "    const unsigned rank = cluster_ctarank(), half = bytes / kCluster;\n"
             "    bulk_copy_g2s_multicast(sm.ring_w + ws * kWBytes + rank * half,"
             " src + rank * half / 2, half, &sm.full_w[ws], (1 << kCluster) - 1);"),
            ("bottleneck.cu", "      mbar_init(&sm.empty_w[s], kGroups * 4);",
             "      mbar_init(&sm.empty_w[s], kCluster * kGroups * 4);"),
            ("bottleneck.cu",
             "      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[rel]);",
             "      if ((threadIdx.x & 31) == 0) {\n"
             "        if (n == C_WS_MARK) mbar_arrive(&empty[rel]);\n"
             "        else for (int c = 0; c < kCluster; ++c)"
             " mbar_arrive_cluster(&empty[rel], c);\n"
             "      }"),
            # the activation ring (kAStages entries) stays per block
            ("bottleneck.cu", "struct Ring {", "constexpr int C_WS_MARK = kAStages;\nstruct Ring {"),
        ]
    return subs


VARIANTS = {
    # stage 0's w2 streamed per tile like the other weights
    "w2_streamed": [("bottleneck.cu", "static constexpr bool RES2 = S == 1 && CW == 64;",
                     "static constexpr bool RES2 = false;")],
    # conv2's next fragments loaded while the previous chunk's products
    # run (ptxas then orders the two itself)
    "fragments_under_products": [
        ("bottleneck.cu",
         "      wgmma_wait<0>();\n      fence_all(af);\n      rw.release(pend_w);\n", ""),
        ("bottleneck.cu", "      wgmma_commit();\n      pend_w = C::RES2 ? 0 : 1;\n",
         "      issued(0, C::RES2 ? 0 : 1);\n")],
    # conv2 with an accumulator array of its own
    "conv2_own_accumulators": [
        ("bottleneck.cu",
         "    auto& acc2 = *reinterpret_cast<float(*)[NB2][C::NW1 / 2]>(acc);",
         "    float acc2[NB2][C::NW1 / 2];")],
    # conv3 on the shared accumulators at every instantiation
    "conv3_shared_everywhere": [
        ("bottleneck.cu", "static constexpr bool SHARE3 = ROWS && CW == 128;",
         "static constexpr bool SHARE3 = true;")],
    "cluster2": _cluster(multicast=False),
    "cluster2_multicast": _cluster(multicast=True),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_bottleneck: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, cuda_ms, ptxas_report, rel_err
    from t5_resnet_vqa_torch.models.resnet import Bottleneck
    from t5_resnet_vqa_torch.models.resnet_vqa import init_weights
    from t5_resnet_vqa_torch.ops import bottleneck as K
    from t5_resnet_vqa_torch.ops import kernel_build

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"ablate_bottleneck: no variant {unknown}; the "
                         f"variants are {list(VARIANTS)}")
    print(card_line(), flush=True)
    built = kernel_build.build_variants(
        "bottleneck", {"shipped": (CSRC, []),
                       **{n: (CSRC, VARIANTS[n]) for n in names}}, OUT)
    fns = {}
    for name, (lib, log) in built.items():
        fn = getattr(ctypes.CDLL(lib), "bottleneck_forward")
        fn.argtypes, fn.restype = K._ARGTYPES, ctypes.c_int
        fns[name] = fn
        print(json.dumps({"variant": name,
                          "ptxas": ptxas_report(log, "bottleneck_bf16")}),
              flush=True)

    def run(fn, x, packed, stride):
        w1, b1, w2, b2, w3, b3, wd, bd = packed.kernel
        B, H, W, _ = x.shape
        cw, cout = packed.plain[0].shape[1], packed.plain[4].shape[1]
        out = torch.empty((B, H // stride, W // stride, cout), dtype=x.dtype,
                          device=x.device)
        ptr = (lambda t: None if t is None else t.data_ptr())
        status = fn(x.data_ptr(), *(ptr(t) for t in (w1, b1, w2, b2, w3, b3,
                                                     wd, bd)),
                    out.data_ptr(), B, H, W, x.shape[3], cw, cout, stride,
                    int(wd is not None), 1,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"bottleneck_forward: CUDA error {status}")
        return out

    def ms(fn):
        return cuda_ms(torch, fn, ITERS, warmup=5)

    with torch.inference_mode():
        for case, H, cin, width, stride, ds in CASES:
            block = Bottleneck(cin, width, stride, ds)
            init_weights(block, torch.Generator().manual_seed(2))
            block = block.to("cuda", torch.bfloat16).eval()
            x = torch.randn(BATCH, H, H, cin, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(3)).to(torch.bfloat16)
            want = K.bottleneck_reference(x, *block.fused.plain, stride=stride)
            for name in names:
                calls = [lambda f=fns[v]: run(f, x, block.fused, stride)
                         for v in ("shipped", name)]
                err = rel_err(calls[1](), want)[1]
                turns = [ms(calls[i]) for i in (0, 1, 1, 0)]
                print(json.dumps({
                    "variant": name, "case": case, "rel_err": err,
                    "ms": (turns[1] + turns[2]) / 2,
                    "shipped_ms": (turns[0] + turns[3]) / 2,
                    "turns_ms": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
