"""Sparse mixture of experts with shared experts (the DeepSeek-V3 block, as
Kimi-VL's language model runs it).

For rows ``x`` [N, D]:

    s      = sigmoid(x W_r^T)                     (fp32, [N, E])
    chosen = top-k of (s + b)                     (b: the correction bias)
    w_i    = s_i / (sum_{j in chosen} s_j + 1e-20) * scale,  i in chosen
    y      = sum_{i in chosen} w_i E_i(x) + S(x)

with ``E_i`` and ``S`` SwiGLU MLPs (``down(silu(gate x) * up x)``). The bias
only picks the experts; the weights are the plain scores. With one group
(``n_group = topk_group = 1``) the published group-limited choice is this
plain top-k. Every row goes to its k experts: no capacity, no dropped row.

Dispatch: the N*k (row, expert) pairs are sorted by expert (a stable
argsort), the rows gathered in that order, and each expert's block run
through its gate/up and down projections by one grouped GEMM each over all
experts (``torch._grouped_mm`` on a bf16 CUDA tensor; a loop of plain
products otherwise). The expert outputs go back to pair order, and each
row's k outputs are combined with its fp32 weights in fp32. Nothing here
reads a count back to the host: the group offsets stay on the device.

The op is the profiler range ``op.moe``; the counters are ``moe.calls``,
``moe.rows`` (pairs routed, k a row) and ``moe.busiest_rows`` (the sum over
calls of the busiest expert's pairs, kept on the device until read).

Inside ``recorded_routes()`` each call's chosen experts are kept, so that a
reference can take the same experts: where two experts' scores nearly tie,
bf16 and fp32 may choose differently, and a changed choice moves a row's
output by a whole expert's share.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import count, span


_recorded: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def recorded_routes() -> Iterator[List[torch.Tensor]]:
    """Yields a list to which every ``moe`` call inside appends its expert
    ids [N, k] (int64, on the device), in call order."""
    global _recorded
    outer, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = outer


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (expert ids [N, k] int64, fp32 weights [N, k]) of rows ``x``."""
    scores = F.linear(x.float(), gate.float()).sigmoid()
    chosen = (scores + bias.float()).topk(top_k, dim=-1).indices
    w = scores.gather(1, chosen)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return chosen, w * scale


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``a`` [R, K] sorted by group, times ``w[g]^T`` ([G, N, K]) for
    the rows of group g, which end at ``offs[g]`` (int32, cumulative)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)
    out = a.new_empty(a.shape[0], w.shape[1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = a[start:end] @ w[g].t()
        start = end
    return out


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def moe(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
        gate_up: torch.Tensor, down: torch.Tensor,
        shared: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
        top_k: int, scale: float) -> torch.Tensor:
    """The layer's output for rows ``x`` [N, D]: ``gate`` [E, D] and
    ``bias`` [E] the router, ``gate_up`` [E, 2I, D] (each expert's gate
    rows, then its up rows) and ``down`` [E, D, I] the experts, ``shared``
    the shared expert's (gate, up, down)."""
    N, D = x.shape
    E, width = gate_up.shape[0], gate_up.shape[1] // 2
    with span("op.moe"):
        chosen, w = route(x, gate, bias, top_k, scale)
        if _recorded is not None:
            _recorded.append(chosen)
        flat = chosen.reshape(-1)
        order = flat.argsort(stable=True)
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        offs = counts.cumsum(0).to(torch.int32)
        rows = x.index_select(0, order // top_k)
        g, u = grouped_mm(rows, gate_up, offs).split(width, dim=-1)
        y = grouped_mm(F.silu(g) * u, down, offs)
        y = torch.empty_like(y).index_copy_(0, order, y)
        out = torch.bmm(w.unsqueeze(1), y.view(N, top_k, D).float())
        out = out.squeeze(1) + swiglu(x, *shared).float()
    count("moe.calls")
    count("moe.rows", N * top_k)
    count("moe.busiest_rows", counts.max())
    return out.to(x.dtype)
