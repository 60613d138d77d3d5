"""Frozen-tower feature cache: each unique image's vision features are
computed once, and every epoch then trains without the tower.

PyTorch counterpart of the JAX package's ``train/feature_cache.py``. A
frozen tower (under ``no_grad`` in the forward) gives each image the same
features in every epoch, and the collates are deterministic per image path,
so the tower's output per image is a constant of the training run. This
module

  * runs the model's own ``compute_vision_features`` (the forward's tower
    math, under the same autocast) over the unique image paths of the train
    and test datasets, in chunks of ``batch_size`` images, the last chunk
    padded to the full size so that every chunk has the training batch's
    shape;
  * keeps the result as one tensor ``[n_images, *feat]`` on the model's
    device, in the dtype the tower computes in (ResNet-50's C5 map:
    ~256 KB per image in bf16; the Faster-RCNN tower's FPN ``pool`` level,
    [4, 4, 256]: 8 KB; the ViT's pooled CLS: 1.5 KB);
  * maps dataset rows to cache slots through the ``_indices`` metadata the
    ``DataLoader`` emits, and gathers ``vision_features`` with
    ``torch.index_select`` on the device, per batch.

The training math is unchanged: the cached features are the tower's
features, and the labels are still drawn anew per epoch in the collate.
The trainer turns the cache off, with a log line, for models without
``compute_vision_features``, fine-tuned towers, towers with stochastic
regularization and rows without an image path.

Under a mesh (``host_resident``, JAX's ``host_mode``) the cache stays on
the host, in pinned memory when the ranks run on cards: every rank builds
it (the tower is replicated, or split over the model axis, and runs in
step on every rank), and each rank gathers the rows of its own share of a
batch and copies them to its device. Where JAX's one process holds one
copy, every rank process holds its own, so the cap counts the copies on
this host (``host_ranks``): the cache stays off where they would pin more
than the cap together.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

# above this estimated size the trainer does not cache (device memory stays
# for activations); generous for DAQUAR-scale image sets
DEFAULT_MAX_CACHE_BYTES = 6 * 1024 ** 3


class FrozenFeatureCache:
    """Per-image tower features, on the device or (a mesh run) on the host
    for ``device``, and the path -> slot map."""

    def __init__(self, features: torch.Tensor, path_to_slot: Dict[str, int],
                 device: Optional[torch.device] = None):
        self.features = features
        self.path_to_slot = path_to_slot
        self.device = features.device if device is None else device

    @property
    def nbytes(self) -> int:
        return self.features.numel() * self.features.element_size()

    def row_map(self, dataset) -> np.ndarray:
        """[len(dataset)] int32: dataset row -> cache slot."""
        return np.asarray(
            [self.path_to_slot[dataset[i].image_path]
             for i in range(len(dataset))], np.int32)

    def gather(self, img_idx: np.ndarray) -> torch.Tensor:
        """[B] slots -> [B, *feat] features on the device (enqueued, not
        waited for); a host cache gathers on the host and copies the rows
        through pinned memory."""
        idx = torch.from_numpy(np.asarray(img_idx, np.int64))
        rows = torch.index_select(self.features, 0,
                                  idx.to(self.features.device))
        if rows.device == self.device:
            return rows
        return rows.pin_memory().to(self.device, non_blocking=True)


def collect_image_slots(datasets: Sequence):
    """One pass over every dataset row: (unique paths in first-seen order,
    one row -> slot array per dataset)."""
    slots: Dict[str, int] = {}
    row_maps: List[np.ndarray] = []
    for ds in datasets:
        rows = np.empty(len(ds), np.int32)
        for i in range(len(ds)):
            rows[i] = slots.setdefault(ds[i].image_path, len(slots))
        row_maps.append(rows)
    return list(slots), row_maps


def build_feature_cache(
    model: nn.Module,
    datasets: Sequence,
    load_images: Callable[[Sequence[str]], np.ndarray],
    batch_size: int = 64,
    max_bytes: int = DEFAULT_MAX_CACHE_BYTES,
    compute_dtype: torch.dtype = torch.float32,
    host_resident: bool = False,
    host_ranks: int = 1,
):
    """Compute the tower's features for every unique image.

    ``load_images`` must be the training collate's own image pipeline
    (``DaquarCollateBase.load_images``), so that the cache sees the pixels
    the forward would. The tower runs under ``no_grad`` and, for a bf16
    ``compute_dtype``, under the train step's autocast. Returns
    ``((cache, row_maps, build_seconds), None)``, with one row -> slot
    array per dataset, or ``(None, reason)`` when the datasets hold no
    image or the cache would exceed ``max_bytes``. ``host_resident`` keeps
    the features in host memory (pinned for a card) for a mesh run;
    ``host_ranks`` processes on this host each hold such a copy, and the
    cap is on their sum.
    """
    t0 = time.time()
    paths, row_maps = collect_image_slots(datasets)
    n = len(paths)
    if not n:
        return None, "datasets reference no images"

    device = next(model.parameters()).device
    features = None
    with torch.no_grad(), torch.autocast(
            device.type, dtype=compute_dtype,
            enabled=compute_dtype != torch.float32):
        for start in range(0, n, batch_size):
            chunk = paths[start:start + batch_size]
            # the tail chunk padded: every chunk has the batch's shape
            pad = batch_size - len(chunk)
            images = torch.from_numpy(np.ascontiguousarray(
                load_images(chunk + [chunk[-1]] * pad))).to(device)
            feats = model.compute_vision_features(images)
            if features is None:
                per_image = feats[0].numel() * feats.element_size()
                if per_image * n * host_ranks > max_bytes:
                    copies = (f" x {host_ranks} ranks on this host"
                              if host_ranks > 1 else "")
                    return None, (f"estimated size {per_image * n / 1e9:.1f} "
                                  f"GB{copies} exceeds the "
                                  f"{max_bytes / 1e9:.0f} GB cap")
                # filled chunk by chunk: no second copy at the peak
                features = torch.empty(
                    (n, *feats.shape[1:]), dtype=feats.dtype,
                    device="cpu" if host_resident else device,
                    pin_memory=host_resident and device.type == "cuda")
            features[start:start + len(chunk)] = feats[:len(chunk)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cache = FrozenFeatureCache(features, {p: i for i, p in enumerate(paths)},
                               device)
    return (cache, row_maps, time.time() - t0), None


class CachedFeatureLoader:
    """Wrap a ``DataLoader``: attach the gathered ``vision_features`` to each
    batch. The collate's ``emit_images`` is off, so a batch carries its text
    feeds and labels, and the features come from a gather on the device in
    place of the images' decoding, copying and tower forward."""

    def __init__(self, loader, cache: FrozenFeatureCache,
                 row_to_slot: np.ndarray):
        self.loader = loader
        self.cache = cache
        self.row_to_slot = row_to_slot

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            slots = self.row_to_slot[np.asarray(batch["_indices"])]
            batch["vision_features"] = self.cache.gather(slots)
            yield batch
