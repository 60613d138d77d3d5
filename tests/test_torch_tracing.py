"""The port's tracing (``utils/profiling.py``): the ``vqa.`` ranges that the
session, the collate, the models, kernel 1, the train step and the input
pipeline open under a profiler, their nesting and counts, that no range
object is made while no profiler records, and the counters.

The cases marked ``gpu`` need a CUDA device and skip without one; the file
imports no JAX, so the machine with the card runs them on their own::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""

import collections
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from t5_resnet_vqa_torch.data import (
    Annotation,
    DataLoader,
    DaquarVitCollate,
    HashTokenizer,
    Prefetcher,
    Question,
    Sample,
)
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.models import (
    CrossAttentionVitVQAModel,
    ResnetVQAModel,
    RobertaConfig,
    T5Config,
    ViTConfig,
)
from t5_resnet_vqa_torch.ops import AttentionConfig
from t5_resnet_vqa_torch.train.trainer import _device_batch, make_train_step
from t5_resnet_vqa_torch.utils import profiling

torch.set_num_threads(2)

ANSWERS = [f"answer{i}" for i in range(7)]
BATCH = 4
LAYERS = 2
SGA_BLOCKS = 2
QUESTIONS = ["what is on the table", "how many chairs are in the room",
             "what is the color of the lamp", "what is behind the sofa"]


def _cnn_model(device="cpu"):
    return ResnetVQAModel(
        len(ANSWERS), vision_model_name="resnet18",
        t5_config=T5Config(d_model=32, d_kv=8, d_ff=64, num_layers=1,
                           num_decoder_layers=1, num_heads=4),
        num_attention_blocks=SGA_BLOCKS,
        sga_config=AttentionConfig(hidden_size=32, num_heads=4, ff_size=32),
        device=device)


def _roberta(dropout=0.0):
    return dataclasses.replace(RobertaConfig.tiny(), vocab_size=32128,
                               dropout_rate=dropout)


def _cross_model(device="cpu", dropout=0.0, dtype=torch.float32,
                 vit=None, roberta=None):
    return CrossAttentionVitVQAModel(
        len(ANSWERS), vit_config=vit or ViTConfig.tiny(),
        roberta_config=roberta or _roberta(dropout), device=device,
        dtype=dtype)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _session(family, device="cpu"):
    if family == "cnn":
        model, size = _cnn_model(device), 64
    else:
        model, size = _cross_model(device), 32
    session = VQAInferenceSession(
        model, None, ANSWERS, family=family, batch_size=BATCH,
        image_size=size, tokenizer=HashTokenizer(pinned_words=ANSWERS),
        device=device)
    pool = _images(16, size)
    # an instance's own image source, as a benchmark hands it
    session.collate.load_images = lambda paths: pool[
        np.fromiter((int(p) for p in paths), np.int64)]
    return session


def _requests(n):
    return [(str(i % 16), QUESTIONS[i % len(QUESTIONS)]) for i in range(n)]


def _ranges(path):
    """{name without the prefix: [(tid, start us, end us)]}, sorted."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = collections.defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith(profiling.PREFIX)):
            out[e["name"][len(profiling.PREFIX):]].append(
                (e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return {k: sorted(v, key=lambda r: r[1]) for k, v in out.items()}


def _inside(child, parent):
    return (child[0] == parent[0] and parent[1] <= child[1]
            and child[2] <= parent[2])


def _each_inside(ranges, child, parent):
    return all(any(_inside(c, p) for p in ranges[parent])
               for c in ranges[child])


def _profiled(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return _ranges(path)


# per forward of the tiny models: (vision, text, fusion, head, attention)
FORWARD_RANGES = {"cnn": (1, 1, 1, 1, 2 * SGA_BLOCKS),
                  "cross_attention": (LAYERS + 1, LAYERS + 1, LAYERS, 1,
                                      2 * LAYERS)}


@pytest.mark.parametrize("family", ["cnn", "cross_attention"])
def test_ask_batch_ranges_nest_and_count_per_chunk(tmp_path, family):
    session = _session(family)
    session.ask_batch(_requests(BATCH), top_k=2)       # warm
    chunks = 3
    ranges = _profiled(
        tmp_path, lambda: session.ask_batch(_requests(chunks * BATCH - 1),
                                            top_k=2))
    for name in ("session.collate", "collate.images", "collate.text",
                 "session.copy", "session.forward", "session.readback",
                 "session.decode"):
        assert len(ranges[name]) == chunks, name
    assert _each_inside(ranges, "collate.images", "session.collate")
    assert _each_inside(ranges, "collate.text", "session.collate")
    vision, text, fusion, head, attention = FORWARD_RANGES[family]
    for name, per in (("model.vision", vision), ("model.text", text),
                      ("model.fusion", fusion), ("model.head", head),
                      ("op.attention", attention)):
        assert len(ranges[name]) == chunks * per, name
        if name.startswith("model."):
            assert _each_inside(ranges, name, "session.forward"), name
    # the attention of each family sits in the part that calls it
    if family == "cnn":
        assert _each_inside(ranges, "op.attention", "model.fusion")
    else:
        assert sum(any(_inside(a, v) for v in ranges["model.vision"])
                   for a in ranges["op.attention"]) == chunks * LAYERS
        assert sum(any(_inside(a, t) for t in ranges["model.text"])
                   for a in ranges["op.attention"]) == chunks * LAYERS
    # every chunk is queued before the first is read back
    assert ranges["session.forward"][-1][2] <= ranges["session.readback"][0][1]


def _samples(n):
    return [Sample(Question(QUESTIONS[i % len(QUESTIONS)], f"q{i}", str(i)),
                   Annotation(f"q{i}", str(i), [ANSWERS[i % len(ANSWERS)]]),
                   str(i % 16)) for i in range(n)]


def _feed(steps, device="cpu"):
    collate = DaquarVitCollate(ANSWERS, emit_uint8=True,
                               tokenizer=HashTokenizer(pinned_words=ANSWERS))
    pool = _images(16, 32)
    collate.load_images = lambda paths: pool[
        np.fromiter((int(p) for p in paths), np.int64)]
    loader = DataLoader(_samples(steps * BATCH), collate, BATCH)
    return Prefetcher(loader, 2, torch.device(device))


def _train_step(model, dtype=torch.float32):
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.AdamW(trainable, lr=1e-3)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0)
    return make_train_step(model, optimizer, scheduler, trainable, 1.0,
                           compute_dtype=dtype)


def _run_steps(model, feed):
    step = _train_step(model.train())
    return [step(_device_batch(raw))[0] for raw in feed]


def test_train_step_and_input_pipeline_ranges(tmp_path):
    model = _cross_model(dropout=0.1)
    steps = 3
    main = threading.get_native_id()
    with profiling.trace(str(tmp_path)) as path:
        _run_steps(model, _feed(steps))
    ranges = _ranges(path)
    parts = ("step.forward", "step.backward", "step.clip", "step.optimizer")
    for name in parts:
        assert len(ranges[name]) == steps, name
        assert {r[0] for r in ranges[name]} == {main}, name
    for i in range(steps):
        spans = [ranges[name][i] for name in parts]
        assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:])), i
    assert _each_inside(ranges, "model.text", "step.forward")
    # one take a batch, one for the end of the pass
    assert len(ranges["input.wait"]) == steps + 1
    assert {r[0] for r in ranges["input.wait"]} == {main}
    producer = {r[0] for r in ranges["input.collate"] + ranges["input.copy"]}
    assert len(producer) == 1 and main not in producer
    assert len(ranges["input.copy"]) == steps
    assert len(ranges["input.collate"]) == steps + 1


def test_no_range_object_without_a_profiler(monkeypatch):
    made = torch.autograd.profiler.record_function.__init__

    def refuse(self, name, *args, **kwargs):
        # PyTorch's optimizers make their own ranges whatever runs
        if name.startswith(profiling.PREFIX):
            raise AssertionError(f"{name} made with no profiler")
        made(self, name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        refuse)
    with pytest.raises(AssertionError):        # the patch holds
        profiling._Range("vqa.x")
    for family in ("cnn", "cross_attention"):
        _session(family).ask_batch(_requests(BATCH + 1))
    _run_steps(_cross_model(dropout=0.1), _feed(2))

    @profiling.span("decorated")
    def twice(x):
        return 2 * x

    assert twice(3) == 6


def test_span_decorates_and_records_under_a_profiler(tmp_path):
    @profiling.span("decorated")
    def twice(x):
        return 2 * torch.as_tensor(x)

    def run():
        twice(1)
        with profiling.span("outer"):
            twice(2)

    ranges = _profiled(tmp_path, run)
    assert len(ranges["decorated"]) == 2 and len(ranges["outer"]) == 1
    assert sum(_inside(d, ranges["outer"][0])
               for d in ranges["decorated"]) == 1
    assert profiling.span("idle") is profiling.span("idle")


def test_counters_count_chunks_and_waits():
    profiling.reset_counters()
    session = _session("cnn")
    session.ask_batch(_requests(2 * BATCH + 1))
    assert profiling.counters()["session.chunks"] == 3
    assert profiling.counters().get("session.pageable_bytes", 0) == 0
    _run_steps(_cross_model(), _feed(3))
    got = profiling.counters()
    assert got["input.waits"] == 4
    assert 0 <= got.get("input.waits_empty", 0) <= got["input.waits"]
    copy = profiling.counters()
    copy["session.chunks"] = -1
    assert profiling.counters()["session.chunks"] == 3
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_counters_are_safe_across_threads():
    profiling.reset_counters()

    def add():
        for _ in range(2000):
            profiling.count("n")

    threads = [threading.Thread(target=add) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert profiling.counters()["n"] == 8000
    profiling.reset_counters()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["cnn", "cross_attention"])
def test_pageable_bytes_per_chunk_on_the_card(cuda, family):
    session = _session(family, device=cuda)
    batch = session._collate_chunk(_requests(BATCH))
    want = sum(np.ascontiguousarray(v).nbytes for v in batch.values())
    profiling.reset_counters()
    session.ask_batch(_requests(3 * BATCH))
    got = profiling.counters()
    assert got["session.chunks"] == 3
    assert got["session.pageable_bytes"] == 3 * want
    profiling.reset_counters()


@pytest.mark.gpu
def test_attention_backward_range_on_autograds_thread(cuda, tmp_path):
    # the kernel's backward takes bf16, D=64, 64 <= S <= 256
    vit = ViTConfig(hidden_size=128, num_layers=1, num_heads=2, mlp_dim=128,
                    patch_size=4, image_size=32)
    roberta = dataclasses.replace(_roberta(), hidden_size=128, num_heads=2,
                                  num_layers=1, intermediate_size=128)
    model = _cross_model(cuda, vit=vit, roberta=roberta)
    step = _train_step(model.train(), torch.bfloat16)
    batch = _device_batch(list(_feed(1, "cuda"))[0])
    step(batch)
    main = threading.get_native_id()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = _ranges(path)
    assert ranges["op.attention_bwd"]
    assert {r[0] for r in ranges["op.attention_bwd"]} - {main}
    assert {r[0] for r in ranges["step.backward"]} == {main}
