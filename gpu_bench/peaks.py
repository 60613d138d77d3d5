"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit) and the rooflines of the port's kernels, counted from
call shapes: each input byte read once, each output byte written once, 2
operations per multiply-add. The counts are the ones ``chip_smoke.py``
uses (``bound_terms``, its kernel phases)."""

from __future__ import annotations

from typing import Mapping, Tuple

PEAK_BYTES_PER_S = 3.35e12            # HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor cores
              "float32": 67e12}       # CUDA cores, no TF32
BF16 = 2


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least seconds: the larger of moving the bytes at the memory
    rate and the operations at the dtype's peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def attention_fwd(call: Mapping, batch: int) -> Tuple[float, float]:
    """(bytes, operations) of one forward: q, k, v read, the output
    written (bf16), and the rows' statistics (float32 m and l) where the
    call writes them; two products of B*H*Sq*Sk*D."""
    B, H, Sq, Sk, D = batch, call["heads"], call["sq"], call["sk"], call["d"]
    nbytes = (2 * Sq + 2 * Sk) * B * H * D * BF16
    if call.get("stats"):
        nbytes += B * H * Sq * 2 * 4
    return nbytes, 4.0 * B * H * Sq * Sk * D


def attention_bwd(call: Mapping, batch: int) -> Tuple[float, float]:
    """(bytes, operations) of one backward: q, k, v and the output's
    gradient read, dq, dk, dv written (bf16); five products."""
    B, H, Sq, Sk, D = batch, call["heads"], call["sq"], call["sk"], call["d"]
    return ((3 * Sq + 4 * Sk) * B * H * D * BF16,
            10.0 * B * H * Sq * Sk * D)


def bottleneck(block: Mapping, batch: int) -> Tuple[float, float]:
    """(bytes, operations) of one fused ResNet-50 block: the input and the
    output (bf16), the BatchNorm-folded weights (bf16) and biases
    (float32) read once; conv1, conv2 (3x3), conv3 and the downsample."""
    H, cin, cw, s = block["h"], block["cin"], block["width"], block["stride"]
    cout, ho = 4 * cw, H // s
    ds = block["downsample"]
    weights = cin * cw + 9 * cw * cw + cw * cout + (cin * cout if ds else 0)
    biases = 2 * cw + cout + (cout if ds else 0)
    nbytes = (batch * (H * H * cin + ho * ho * cout) + weights) * BF16 \
        + biases * 4
    flops = 2.0 * batch * (H * H * cin * cw + ho * ho * 9 * cw * cw
                           + ho * ho * cw * cout
                           + (ho * ho * cin * cout if ds else 0))
    return nbytes, flops
