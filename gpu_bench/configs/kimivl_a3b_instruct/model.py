"""``kimivl_a3b_instruct`` on the program: the port's ``KimiVLModel`` at
the widths of ``config.json``, built on ``meta`` so that it holds no
weights until the benchmark's are loaded into it as they are, and the
benchmark's weights: each tensor of ``weight_spec`` drawn on the device
from its own sub-seed of the run's seed (``harness.sub_seed(seed,
WEIGHTS, i)``), so that one tensor can be drawn again alone. The program
holds each draw rounded to its compute dtype; the reference reads the
same values in float32 through ``LazyWeights``, a layer at a time. What the
generate mode needs besides is in ``generate.py``. The plain reference
is ``gpu_bench/reference/kimi_vl.py``."""

from __future__ import annotations

from typing import Dict, Iterator, Mapping

from gpu_bench import harness
from gpu_bench.reference import kimi_vl as reference

FAMILY = "kimi_vl"


def build(cfg: Mapping, device=None):
    """The port's model on ``meta`` in the configuration's compute dtype
    (the session loads the weights with ``assign=True``; ``device`` is
    where they will live)."""
    import torch

    from t5_resnet_vqa_torch.models import KimiVLConfig, build_kimi_vl

    config = KimiVLConfig.from_dict(
        cfg, cfg["vision"], cfg["media_placeholder_token_id"],
        cfg["special_tokens"], cfg["max_question_tokens"])
    return build_kimi_vl(config, device="meta",
                         dtype=getattr(torch, cfg["compute_dtype"]))


def draw(spec, index: int, seed: int, device) -> "torch.Tensor":
    """Tensor ``index`` of ``spec`` in float32, from its own sub-seed."""
    import torch

    name, shape, kind, mean, std = spec[index]
    if kind != "normal":
        raise ValueError(f"unknown weight kind {kind!r} for {name}")
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, harness.WEIGHTS, index))
    return torch.randn(shape, generator=gen, device=device) * std + mean


def program_weights(cfg: Mapping, seed: int, device
                    ) -> Dict[str, "torch.Tensor"]:
    """Every weight in the compute dtype, drawn one at a time (at most one
    float32 tensor held beside them)."""
    import torch

    dtype = getattr(torch, cfg["compute_dtype"])
    spec = reference.weight_spec(cfg)
    return {spec[i][0]: draw(spec, i, seed, device).to(dtype)
            for i in range(len(spec))}


class LazyWeights(Mapping):
    """The weights the program holds for a seed (each draw rounded to the
    compute dtype), in float32, each drawn anew when it is read and held
    by no one here."""

    def __init__(self, cfg: Mapping, seed: int, device):
        import torch

        self.spec = reference.weight_spec(cfg)
        self.index = {s[0]: i for i, s in enumerate(self.spec)}
        self.seed, self.device = seed, device
        self.dtype = getattr(torch, cfg["compute_dtype"])

    def __getitem__(self, name: str):
        w = draw(self.spec, self.index[name], self.seed, self.device)
        return w.to(self.dtype).float()

    def __iter__(self) -> Iterator[str]:
        return iter(self.index)

    def __len__(self) -> int:
        return len(self.index)
