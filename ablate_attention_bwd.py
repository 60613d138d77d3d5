#!/usr/bin/env python3
"""Ablated builds of kernel 1's backward (``csrc/attention_bwd.cu``), timed
against the shipped one on one NVIDIA GPU (Hopper, sm_90a).

    python3 ablate_attention_bwd.py [--parent DIR] [variant ...]

Each variant is ``t5_resnet_vqa_torch/csrc/attention_bwd.cu`` (with
``sm90_common.cuh``) changed by the text substitutions listed for it in
``VARIANTS``, each of which must match the shipped source exactly once.
``no_prefetch`` loads the next head's Q and K only after the current head's
last barrier, not when it starts, so that the loads are exposed (what the
ring is worth). The others are diagnostic, wrong by design, and show what
a part of the kernel costs: ``no_ex2`` (no exponentials), ``no_cvt`` (bf16
by cutting, not by conversions), ``phase1_only`` and ``phase2_only`` (one
phase of each head skipped). A name that is not in ``VARIANTS`` is an
error; without names, every variant runs. ``--parent DIR`` adds the
backward kernel of another tree of this repo (its
``t5_resnet_vqa_torch/csrc``, which takes no row statistics) as variant ``parent``, so that a
design can be timed against an earlier one. Every variant is built with
``nvcc -Xptxas -v`` (all at once, by ``kernel_build.build_variants``) into
the package's git-ignored ``_build/ablate_bwd/``; one JSON line per
variant gives ptxas's registers, spills and serialization warnings per
instantiation, and the text of each warning. Then, at the ViT and RoBERTa
shapes (bf16, B=64, H=12 and a tp=2 rank's H=6, D=64), on head views of
[B, S, H*D] projections and the gradient as the main path hands it back,
each variant runs on the same inputs and row statistics as the shipped
kernel, in turns (shipped, variant, variant, shipped): one JSON line per
variant and shape with both mean device times (the profiler's kernel time
over 20 launches after a warm-up, as ``chip_smoke.py`` times kernels) and
both kernels' error against the plain VJP relative to max|plain| (the
largest of dq, dk and dv). The card's name and power limit come first, as
``nvidia-smi`` gives them. Without a CUDA device it exits with an error.
"""

import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "t5_resnet_vqa_torch", "csrc")
OUT = os.path.join(REPO, "t5_resnet_vqa_torch", "_build", "ablate_bwd")
CASES = [    # name, B, H, S
    ("vit_s197", 64, 12, 197),
    ("cross_s213", 64, 12, 213),
    ("vit_s197_tp2", 64, 6, 197),
    ("cross_s213_tp2", 64, 6, 213),
]
ITERS = 20
VARIANTS = {
    "no_prefetch": [
        ("attention_bwd.cu",
         "      if (item + gridDim.x < g.items) "
         "load_in(slot ^ 1, item + gridDim.x);\n", ""),
        ("attention_bwd.cu",
         "    __syncthreads();              "
         "// the head's buffers are free for the next one\n",
         "    __syncthreads();\n"
         "    if (threadIdx.x == 0 && item + gridDim.x < g.items)\n"
         "      load_in(slot ^ 1, item + gridDim.x);\n")],
    "no_ex2": [("sm90_common.cuh",
                'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;")],
    "no_cvt": [("sm90_common.cuh",
                "__nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
                "  return *reinterpret_cast<unsigned*>(&v);",
                "return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), "
                "0x7632);")],
    "phase1_only": [("attention_bwd.cu",
                     "for (int kt = group; kt < N64 / kRows; kt += kGroups)",
                     "for (int kt = group; kt < 0 * N64; kt += kGroups)")],
    "phase2_only": [("attention_bwd.cu",
                     "for (int qt = group; qt < g.nqt; qt += kGroups)",
                     "for (int qt = group; qt < 0; qt += kGroups)")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_attention_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, device_ms, ptxas_report, rel_err
    from t5_resnet_vqa_torch.ops import attention as A
    from t5_resnet_vqa_torch.ops import kernel_build

    args = sys.argv[1:]
    sources = {"shipped": (CSRC, [])}
    if args[:1] == ["--parent"]:
        sources["parent"] = (os.path.join(os.path.abspath(args[1]),
                                          "t5_resnet_vqa_torch", "csrc"), [])
        args = args[2:]
    unknown = [n for n in args if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"ablate_attention_bwd: no variant {unknown}; the "
                         f"variants are {list(VARIANTS)}")
    args = args or list(VARIANTS)
    sources.update({name: (CSRC, VARIANTS[name]) for name in args})
    names = [n for n in sources if n != "shipped"]
    print(card_line(), flush=True)
    fns = {}
    for name, (lib, log) in kernel_build.build_variants(
            "attention_bwd", sources, OUT).items():
        fn = getattr(ctypes.CDLL(lib), "attention_backward_tma")
        # the parent's entry takes no row statistics
        argtypes = list(A._BWD_ARGTYPES)
        if name == "parent":
            del argtypes[4]
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
        print(json.dumps({"variant": name,
                          "ptxas": ptxas_report(log, "attention_bwd_tma"),
                          "warning_texts": sorted({
                              line.split("(", 1)[1]
                              .split(" in the function")[0]
                              for line in log.splitlines()
                              if "(C75" in line})}),
              flush=True)

    def run(name, q, k, v, g, stats):
        B, H, Sq, D = q.shape
        outs = [torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
                for _ in range(3)]
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr()]
        if name != "parent":
            ptrs.append(stats.data_ptr())
        status = fns[name](*ptrs, *(t.data_ptr() for t in outs), B, H, Sq,
                           Sq, D, *q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3], *g.stride()[:3], 1,
                           torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"{name}: CUDA error {status}")
        return [t.transpose(1, 2) for t in outs]

    def ms(fn):
        return device_ms(torch, fn, ITERS)

    def err(got, want):
        return max(rel_err(a, b)[1] for a, b in zip(got, want))

    for case, B, H, S in CASES:
        gen = torch.Generator(device="cuda").manual_seed(6)
        q, k, v = (torch.randn(B, S, H * 64, device="cuda", generator=gen)
                   .to(torch.bfloat16).reshape(B, S, H, 64).transpose(1, 2)
                   for _ in range(3))
        g = torch.randn(B, S, H, 64, device="cuda", generator=gen) \
            .to(torch.bfloat16).transpose(1, 2)
        _, stats = A._launch(q, k, v, stats=True)
        want = A.attention_backward(q, k, v, g, route="plain")
        shipped_err = err(run("shipped", q, k, v, g, stats), want)
        for name in names:
            calls = [lambda n=n: run(n, q, k, v, g, stats)
                     for n in ("shipped", name)]
            turns = [ms(calls[i]) for i in (0, 1, 1, 0)]
            print(json.dumps({
                "variant": name, "case": case, "shape": [B, H, S, S, 64],
                "rel_err": err(calls[1](), want),
                "shipped_rel_err": shipped_err,
                "ms": (turns[1] + turns[2]) / 2,
                "shipped_ms": (turns[0] + turns[3]) / 2,
                "turns_ms": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
