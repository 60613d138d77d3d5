"""Multi-head latent attention (MLA, DeepSeek-V2/V3), the two cores that
Kimi-VL's language model runs; the projections around them are in
``models/kimi_vl.py``.

* ``mla_prefill`` (range ``op.mla``): causal attention over a prompt with
  per-head q and k of the no-position and rotary parts together
  ([B, H, S, 192]) and v of 128, scale 1/sqrt(192). Prompts are padded on
  the right, so the causal mask alone keeps every real position off the
  padding. SDPA computes it.
* ``mla_decode`` (range ``op.mla_decode``): one query a row against the
  latent cache ``[B, T, C + R]`` (C = 512 normalised latent values, then
  the R = 64 rotated shared key values a position), with the key half of
  ``W_kvb`` already folded into q: ``q = [W_uk^T q_nope, q_pe]`` per head
  ([B, H, C + R]). Scores ``q . cache`` (fp32 out), masked past each row's
  position, softmax in fp32, and the weighted sum of the latent values
  ``[B, H, C]``, which the caller takes through the value half of
  ``W_kvb``. No per-head key or value is formed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span


@span("op.mla")
def mla_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float) -> torch.Tensor:
    """q, k [B, H, S, Dqk], v [B, H, S, Dv] -> [B, H, S, Dv]."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          scale=scale)


def _scores(q: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """fp32 q . cache^T: [B, H, C + R] x [B, T, C + R] -> [B, H, T]."""
    if q.is_cuda and q.dtype != torch.float32:
        return torch.bmm(q, cache.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(q.float(), cache.transpose(1, 2).float())


@span("op.mla_decode")
def mla_decode(q: torch.Tensor, cache: torch.Tensor, positions: torch.Tensor,
               latent: int, scale: float) -> torch.Tensor:
    """q [B, H, C + R] against ``cache`` [B, T, C + R]; row b sees cache
    positions 0..positions[b]. -> the latent output [B, H, C]."""
    s = _scores(q, cache) * scale
    past = torch.arange(cache.shape[1], device=cache.device) \
        > positions[:, None]
    p = s.masked_fill(past[:, None, :], float("-inf")).softmax(dim=-1)
    return torch.bmm(p.to(cache.dtype), cache[..., :latent])
