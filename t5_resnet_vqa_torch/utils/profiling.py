"""Tracing: named ranges where the work happens, counters, and a profiler
for a block (the JAX package's ``utils/profiling.py``).

The reference's only observability is wall-clock secs/batch logging
(faster_rcnn_vqa_trainer.py:331-339). The trainer keeps that log format and
adds:

  * ``span(name)`` — a context manager, and a decorator, that opens the
    ``torch.profiler`` range ``vqa.<name>`` while a profiler records, and
    does nothing otherwise: no range object, no clock read, only the check
    whether a profiler runs. It keeps no clock and has no switch of its own:
    any running ``torch.profiler`` switches the ranges on (the trainer's
    ``trace_dir``, a benchmark's traced stretch, an operator's own). The
    ranges lie in the Chrome trace on the profiler's clock beside the device
    operations, so that a device operation can be put down, through its
    launch, to the innermost ``vqa.`` range its launching thread was in.
  * ``count(name, n)``, ``counters()``, ``reset_counters()`` — plain integer
    counters, always on and safe to update from any thread.
  * ``trace(logdir)`` — a context manager around ``torch.profiler`` over the
    CPU and, where a card is present, CUDA activities, following every
    thread where the installed PyTorch can (the input pipeline's producer
    thread included), writing a Chrome trace (``trace_<pid>.json``,
    viewable in Perfetto or chrome://tracing) into ``logdir``.

The ranges (each ``vqa.`` + the name):

  * serving (``eval/session.py``), per chunk: ``session.collate`` (collate
    and pad), inside it ``collate.images`` (the collate's ``load_images``)
    and ``collate.text`` (tokenising); ``session.copy`` (the copy to the
    device); ``session.forward`` (queueing the forward); per chunk once its
    results are wanted: ``session.readback`` (the host blocked on the
    device's results) and ``session.decode`` (top-k answers);
  * the models' forward (the CNN family's ``ResnetVQAModel`` and the
    cross-attention family's ``CrossAttentionVitVQAModel``):
    ``model.vision`` (the ResNet tower; the ViT embeddings and each ViT
    layer), ``model.text`` (the T5 encoder; the RoBERTa embeddings and each
    RoBERTa layer), ``model.fusion`` (projection and SGA blocks; each
    layer's concat and LayerNorm), ``model.head`` (pooler, classifier,
    log-softmax);
  * Kimi-VL (``models/kimi_vl.py``): ``model.vision`` (MoonViT and the
    projector), ``model.prefill`` (the decoder over the prompt),
    ``model.decode`` (one a cached decode step), and its ops ``op.mla``
    (prefill attention), ``op.mla_decode`` (attention over the latent
    cache) and ``op.moe`` (``ops/moe.py``: routing, dispatch, the experts'
    grouped products, combine and shared expert);
  * kernel 1 (``ops/attention.py``): ``op.attention`` around every
    ``fused_attention`` call, ``op.attention_bwd`` around the CUDA path of
    its backward, on the thread autograd runs it on;
  * the train step (``train/trainer.py``): ``step.forward``,
    ``step.backward``, ``step.clip``, ``step.optimizer`` (the optimizer's
    and the schedule's step);
  * the input pipeline (``data/pipeline.py``): ``input.wait`` (the step
    waiting for the next batch) on the consumer's thread, and on the
    producer's thread ``input.collate`` (the loader's next batch) and
    ``input.copy`` (pinning and copying it to the device).

The counters: ``session.chunks`` (chunks collated), ``session.pageable_bytes``
(bytes the session copies to a CUDA device from pageable host memory),
``input.waits`` (the consumer's takes from the prefetcher's queue: one a
batch, and one at the end of a pass), ``input.waits_empty`` (of those,
the ones that found the queue empty, so that the step waited for the
producer); ``text.forwards`` (every ``T5Encoder`` forward, in
``models/t5.py``), ``text.graph_replays`` (those that ran as a replay of
a CUDA graph) and ``text.graph_captures`` (one per captured signature);
``moe.calls``, ``moe.rows`` (rows routed, top-k counted) and
``moe.busiest_rows`` (the sum over calls of the busiest expert's rows, a
device count), ``generate.prefills`` and ``generate.steps`` (Kimi-VL's
cached generation, ``models/generation.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "vqa."

_lock = threading.Lock()
_counters: Dict[str, int] = collections.Counter()
_pending: Dict[str, torch.Tensor] = {}


def _recording() -> bool:
    """Whether a profiler runs: the process-wide flag that every Python
    entry of ``torch.profiler`` and ``torch.autograd.profiler`` raises. It
    is the same on every thread, so that a thread the profiler follows
    (autograd's, or the prefetcher's under ``trace``) opens its ranges;
    ``torch.autograd._profiler_enabled()`` is true only on the thread that
    started the profiler and those that inherit its state."""
    return _autograd_profiler._is_profiler_enabled


class _Idle:
    """What ``span`` gives while no profiler records: a context that does
    nothing, one shared per name; as a decorator, a span around each call
    of the function."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Range(_autograd_profiler.record_function):
    """A recorded range; as a decorator, like ``_Idle``."""

    def __call__(self, fn):
        return _Idle(self.name[len(PREFIX):])(fn)


_idle: Dict[str, _Idle] = {}


def span(name: str):
    """The profiler range ``vqa.<name>`` while a profiler records, a shared
    context that does nothing otherwise; usable as a context manager and as
    a decorator."""
    if _recording():
        return _Range(PREFIX + name)
    idle = _idle.get(name)
    if idle is None:
        idle = _idle.setdefault(name, _Idle(name))
    return idle


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``. ``n`` may be a one-element
    tensor on a device: it is summed there, with no wait for the device,
    and read into the counter when ``counters()`` is next called."""
    with _lock:
        if isinstance(n, torch.Tensor):
            n = n.detach().reshape(()).to(torch.int64)
            held = _pending.get(name)
            _pending[name] = n if held is None else held + n
        else:
            _counters[name] += n


def counters() -> Dict[str, int]:
    """A copy of every counter (a device count waits for its device)."""
    with _lock:
        for name, n in _pending.items():
            _counters[name] += int(n)
        _pending.clear()
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()
        _pending.clear()


def _all_threads_config():
    """The profiler's option to follow every thread of the process, where
    the installed PyTorch has it; None otherwise."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block and write its Chrome trace into ``logdir``; yields
    the trace's path. Device activity is traced when CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    with profile(activities=activities,
                 experimental_config=_all_threads_config()) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
