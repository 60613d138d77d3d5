"""``cnn_resnet50_t5base`` on the program: the port's ``ResnetVQAModel``
at the widths of ``config.json``, and the vision tower's shapes. What one
mode needs besides (its counts and its reference step) is in the mode's
file beside this one (``serve.py``). The plain reference is
``gpu_bench/reference/cnn.py``."""

from __future__ import annotations

from typing import Mapping

from gpu_bench.reference import cnn as reference

FAMILY = "cnn"


def build(cfg: Mapping, device, dropout: bool = False):
    """The port's model on ``device`` in float32, kernels on. Its own
    initial weights are replaced by the benchmark's."""
    import torch

    from t5_resnet_vqa_torch.models import ResnetVQAModel, T5Config
    from t5_resnet_vqa_torch.ops import AttentionConfig

    t, s = dict(cfg["t5"]), cfg["sga"]
    rate = {} if dropout else {"dropout_rate": 0.0}
    t.update(rate)
    return ResnetVQAModel(
        cfg["answers"], vision_model_name=cfg["resnet"]["variant"],
        t5_config=T5Config(**t), num_attention_blocks=s["blocks"],
        sga_config=AttentionConfig(
            hidden_size=cfg["hidden_size"], num_heads=s["num_heads"],
            ff_size=s["ff_size"],
            dropout_rate=s["dropout_rate"] if dropout else 0.0),
        use_kernels=True, dtype=torch.float32, device=device,
        generator=torch.Generator().manual_seed(0))


def tower(cfg: Mapping):
    """(tokens of C5, MACs of the ResNet, the fused stages' blocks)."""
    r, size = cfg["resnet"], cfg["image_size"]
    h = size // 2                                       # the 7x7/s2 stem
    macs = h * h * r["stem_channels"] * 3 * 49
    h //= 2                                             # the max pool
    cin, blocks = r["stem_channels"], []
    for stage, (depth, width) in enumerate(zip(r["depths"], r["widths"])):
        cout = width * r["expansion"]
        for b in range(depth):
            stride = 2 if stage > 0 and b == 0 else 1
            c_in = cin if b == 0 else cout
            ho = h // stride
            block = (h * h * c_in * width + ho * ho * 9 * width * width
                     + ho * ho * width * cout
                     + (ho * ho * c_in * cout if b == 0 else 0))
            macs += block
            if stage in r["fused_stages"]:
                blocks.append({"h": h, "cin": c_in, "width": width,
                               "stride": stride, "downsample": b == 0})
            h = ho
        cin = cout
    return h * h, macs, blocks
