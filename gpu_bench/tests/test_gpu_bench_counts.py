"""The FLOP and byte counts at the published widths, against the bounds
PERF.md's kernel table gives at B=64 (counted by ``chip_smoke.py``), and
the model FLOPs against counts made by hand."""

from __future__ import annotations

import pytest

from gpu_bench import harness, peaks

BENCH = harness.Bench()
CNN = BENCH.config("cnn_resnet50_t5base")
CROSS = BENCH.config("cross_vitbase_robertabase")
CNN_MODEL = BENCH.model("cnn_resnet50_t5base")
CNN_SERVE = BENCH.part("cnn_resnet50_t5base", "serve")
CROSS_SERVE = BENCH.part("cross_vitbase_robertabase", "serve")
CROSS_TRAIN = BENCH.part("cross_vitbase_robertabase", "train")


def _ms(counts):
    return 1e3 * peaks.bound_s(*counts)


def test_bottleneck_bound_per_forward_at_b64():
    blocks = CNN_SERVE.bottleneck_blocks(CNN)
    assert len(blocks) == 7
    total = sum(_ms(peaks.bottleneck(b, 64)) for b in blocks)
    assert total == pytest.approx(0.3941, abs=5e-5)


@pytest.mark.parametrize("index, want", [(0, 0.0501), (1, 0.0802),
                                         (3, 0.0630), (4, 0.0402)])
def test_bottleneck_bound_per_block_at_b64(index, want):
    block = CNN_SERVE.bottleneck_blocks(CNN)[index]
    assert _ms(peaks.bottleneck(block, 64)) == pytest.approx(want, abs=5e-5)


def test_attention_bounds_at_b64():
    calls = CROSS_SERVE.attention_calls(CROSS)
    s213 = next(c for c in calls if c["sq"] == 213)
    s197 = next(c for c in calls if c["sq"] == 197)
    assert _ms(peaks.attention_fwd(s213, 64)) == pytest.approx(0.02500,
                                                               abs=5e-6)
    assert _ms(peaks.attention_fwd(s197, 64)) == pytest.approx(0.02312,
                                                               abs=5e-6)
    bwd = CROSS_TRAIN.attention_bwd_calls(CROSS)
    assert len(bwd) == 12
    assert _ms(peaks.attention_bwd(bwd[0], 64)) == pytest.approx(0.04375,
                                                                 abs=5e-6)


def test_sga_bound_per_cnn_forward_at_b64():
    calls = CNN_SERVE.attention_calls(CNN)
    assert [c["sk"] for c in calls] == [16, 64, 16, 16, 16, 16]
    total = sum(_ms(peaks.attention_fwd(c, 64)) for c in calls)
    assert total == pytest.approx(0.01409, abs=5e-6)


def test_training_forward_writes_statistics():
    calls = CROSS_TRAIN.attention_calls(CROSS)
    assert sum(c["stats"] for c in calls) == 12
    with_stats = next(c for c in calls if c["stats"])
    no_stats = dict(with_stats, stats=False)
    extra = peaks.attention_fwd(with_stats, 64)[0] \
        - peaks.attention_fwd(no_stats, 64)[0]
    assert extra == 64 * 12 * 213 * 2 * 4


def test_cnn_flops_per_pair():
    # ResNet-50 at 224^2 is 4.09 GMAC (its paper's 3.8 G counts the stem
    # and the classifier differently); 256^2 scales it by (256/224)^2
    flops = CNN_SERVE.flops_per_sample(CNN)
    resnet = 2 * CNN_MODEL.tower(CNN)[1]
    assert resnet == pytest.approx(2 * 4.09e9 * (256 / 224) ** 2, rel=0.02)
    projection = 2 * 64 * 768 * 2048 * 9
    t5 = 2 * 12 * (16 * (4 * 768 * 768 + 2 * 768 * 3072) + 2 * 16 * 16 * 768)
    h2 = 768 * 768
    sga = 2 * (4 * 16 * h2 + (2 * 16 + 2 * 64) * h2 + 2 * 16 * h2  # block 0
               + 2 * (4 * 16 * h2 + 4 * 16 * h2 + 2 * 16 * h2))     # 1 and 2
    assert flops == pytest.approx(resnet + projection + t5 + sga, rel=0.01)
    assert 15.5e9 < flops < 16.1e9


def test_cross_flops_per_sample():
    layer = lambda S, ff: S * (4 * 768 ** 2 + 2 * 768 * ff) + 2 * S * S * 768
    vit = 196 * 768 * 768 + 12 * layer(197, 3072)
    roberta = 12 * layer(213, 3072)
    serve = CROSS_SERVE.flops_per_sample(CROSS)
    train = CROSS_TRAIN.flops_per_sample(CROSS)
    assert serve == pytest.approx(2 * (vit + roberta), rel=1e-3)
    assert train == pytest.approx(2 * (vit + 3 * roberta), rel=1e-3)
    assert 72e9 < serve < 74e9 and 148e9 < train < 151e9
