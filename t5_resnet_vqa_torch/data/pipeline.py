"""Input pipeline: fixed-size batches, produced and copied to the device in a
background thread.

PyTorch counterpart of the JAX package's ``data/pipeline.py``.
``DataLoader`` is a copy: the same shuffle order for the same seed
(``np.random.default_rng(seed)``), the same padding of a last partial batch
(its first sample repeated) and the same ``_valid`` / ``_indices`` host
metadata. ``Prefetcher`` runs the loader in a thread, up to
``num_prefetch`` batches ahead; given a device it turns each array into a
tensor there: for a CUDA device through pinned host memory and a copy with
``non_blocking=True`` (in place of ``jax.device_put``). The copies go on the
thread's current stream, which is the device's default stream, the one
the train and eval steps run on, so a step never reads a batch whose copy
has not landed.

The consumer's wait for a batch is the range ``input.wait``, and the
producer's work the ranges ``input.collate`` and ``input.copy``
(``utils/profiling.py``). The counters ``input.waits`` and
``input.waits_empty`` count the consumer's takes from the queue (one a
batch, and one at the end of a pass) and those that found it empty, so
that the step waited for the producer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..utils.profiling import count, span


class DataLoader:
    """Map-style loader: dataset + collate -> fixed-size batches.

    drop_remainder=True keeps every batch the same shape. With
    drop_remainder=False the last partial batch is padded up to batch_size
    by repeating its first sample, and ``_valid`` says how many rows are
    real so that metrics can ignore the padding.
    """

    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = True):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if len(idx) < bs:
                if self.drop_remainder:
                    return
                valid = len(idx)
                idx = np.concatenate([idx, np.repeat(idx[:1], bs - len(idx))])
            else:
                valid = bs
            samples = [self.dataset[int(i)] for i in idx]
            batch = self.collate_fn(samples)
            batch["_valid"] = np.asarray(valid, np.int32)
            # dataset row ids (host metadata, stripped before the model)
            batch["_indices"] = idx.astype(np.int32)
            yield batch


def to_device(batch: dict, device: torch.device) -> dict:
    """Array values of ``batch`` as tensors on ``device`` (CUDA: pinned and
    copied without blocking); "_"-prefixed host metadata and non-array
    values pass through. ``_host_annotation_ids`` keeps the labels on the
    host, so that metric accounting never waits for the device."""
    out = {}
    for k, v in batch.items():
        if (isinstance(v, np.ndarray) and v.dtype != object and v.ndim
                and not k.startswith("_")):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        else:
            out[k] = v
    if isinstance(batch.get("annotation_ids"), np.ndarray):
        out["_host_annotation_ids"] = batch["annotation_ids"]
    return out


class Prefetcher:
    """Wrap any batch iterable; produce batches from a background thread,
    moved to ``device`` when one is given."""

    def __init__(self, loader, num_prefetch: int = 2,
                 device: Optional[torch.device] = None):
        self.loader = loader
        self.num_prefetch = max(1, num_prefetch)
        self.device = device

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def producer():
            try:
                batches = iter(self.loader)
                while True:
                    with span("input.collate"):
                        batch = next(batches, sentinel)
                    if batch is sentinel:
                        return
                    if self.device is not None:
                        with span("input.copy"):
                            batch = to_device(batch, self.device)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("input.wait"):
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        count("input.waits_empty")
                        item = q.get()
                count("input.waits")
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early (an exception in a step, an
            # interrupt) releases the producer instead of leaving it blocked
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
