"""The VQA trainer for the four families (CNN with a ResNet or a
Faster-RCNN tower, ViT + T5 encoder-decoder, ViT x RoBERTa cross-attention).

PyTorch counterpart of ``VQATrainer`` and ``make_train_step`` of the JAX
package's ``train/trainer.py``, with its log lines and artifacts:

  * startup: WUPS mode, the parameter table, the dataloader summary, the
    optimizer groups, the scheduler and the callbacks;
  * per epoch: step logs (every step for epochs under 10 batches, else
    every 10% with per-group LRs and secs/batch), the epoch's train WUPS,
    then validation: loss, WUPS, best-model checkpoint and
    ``validation_predictions/<epoch>_validation_predictions.json``;
  * per epoch end: the ``checkpoint-model.pt`` + ``state_dict_checkpoint.pt``
    pair (model weights; epoch + 1, global step, optimizer and scheduler
    state) as one background save, and ``training_progress.json``
    synchronously; with ``checkpoint_every_steps`` the pair also every N
    steps (it carries the running epoch, which a resume runs again); with
    ``max_checkpoint_lag_epochs`` the loop waits for the saves when the
    last landed pair trails training by more epochs than that;
  * ``load_from_checkpoint`` resumes from the pair (weights, AdamW moments,
    the schedule's position, epoch and step), or else from ``best-model.pt``
    weights alone, and reports how far the previous run had got;
  * ``trace_dir``: a ``torch.profiler`` Chrome trace of epoch 0's steps,
    over every thread, with the port's ``vqa.`` ranges
    (``utils/profiling.py``: the step's forward, backward, clip and
    optimizer, the input pipeline's wait, collate and copy, the model's
    parts, kernel 1);
    ``compute_rouge``: ROUGE-1/2/L of the validation predictions;
  * ``metrics.jsonl`` records; KeyboardInterrupt saves and stops.

One train step (``make_train_step``) is the JAX step in PyTorch: forward
with dropout on (the model in ``train()``), backward, global-norm clip of
the trainable gradients, AdamW step, schedule step. Dropout draws from
torch's generator, seeded from ``trainer.seed``; its bits differ from
JAX's, so parity runs use dropout 0.

bf16 compute (``model.compute_dtype="bfloat16"`` or ``mxp_training``)
keeps fp32 master weights in the trainable modules and runs the forward
under ``torch.autocast(dtype=torch.bfloat16)``; the frozen tower has no
master weights and is held in bf16 (``prepare_model``), so the fused
bottleneck stages get bf16 activations and operands. A fine-tuned tower
keeps fp32 master weights like the rest.

The family decides only the collate (``DaquarCnnCollate`` for the CNN
family, ``DaquarVitCollate`` for the other two) and, for the ViT family,
the adaptive token lengths
(``dataset_kwargs.adaptive_question_len``): the question and decoder
lengths shrink to the longest tokenized question of the two datasets, which
changes no number (trailing pad columns are masked everywhere in that
family). The steps are family-blind. With ``cache_frozen_features`` (the
reference config's setting) a frozen tower runs once per unique image
before the first epoch (``train/feature_cache.py``), and the steps take the
gathered ``vision_features`` in place of the images (the Faster-RCNN
tower's ``pool`` level, the ResNet's C5 map, the ViT's pooled CLS); the
cross-attention family has no separable tower, and the cache stays off with
JAX's log line.

The data is DAQUAR, or OK-VQA with ``dataset_kwargs.dataset_type="okvqa"``
(``data/okvqa.py``: the COCO-style JSONs through the DAQUAR collates, one
of the 10 annotator answers drawn per epoch); ``reduced_decode`` and
``num_workers`` reach the collates' image loader. Knobs of the JAX trainer
that change nothing in the numbers are named in one startup log line and
otherwise ignored. As in the JAX package, a resume restores neither the
shuffle order nor the dropout generator: a resumed epoch does not replay
an uninterrupted one.

Under a ``mesh`` (``parallel/``; one process per rank, each running this
trainer in step) the model is split over the model axis
(``shard_model_``) and wrapped in DDP over the data axis; every rank reads
the same global batches and takes its rows; the frozen-feature cache stays
on the host; the clip and the optimizers reduce over the full tensors.
Losses and predictions are averaged and gathered over the data axis, rank
0 computes WUPS and ROUGE and alone writes logs, records and checkpoints,
which hold the gathered full weights and optimizer state in the
single-device layout (a resume shards them again). Every rank draws the
dropout masks of the full global batch from one seed and keeps its block
(``MeshDropout``): the replicas of a model group stay equal, and on the
CPU a mesh drops what the single-device run drops.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..core import constants
from ..core.config import Config, DatasetConfig
from ..core.device import resolve_device
from ..core.logging import ExperimentTracker, Logger
from ..data import (
    DaquarCnnCollate,
    DaquarDataset,
    DaquarVitCollate,
    DataLoader,
    Prefetcher,
    get_tokenizer,
    load_answer_spaces,
)
from ..eval.rouge import compute_rouge_metric, stemming_active
from ..eval.wups import average_wups, wup_measure, wups_mode
from ..parallel import sharding as shd
from ..parallel.tensor_parallel import (
    TensorParallel,
    clip_grad_norm_,
    shard_model_,
    tp_dim,
)
from ..utils import profiling
from ..utils.time_utils import convert_time_to_readable_format
from .callbacks import EarlyStopping
from .factory import CNN_FAMILY, VIT_FAMILY, build_model, model_family
from .feature_cache import CachedFeatureLoader, build_feature_cache
from .optimizer import (
    FROZEN_LABEL,
    build_optimizer,
    label_params,
    state_split_dim,
)

_EVAL_ONLY_KEYS = ("answers", "questions", "image_fns")


def _device_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The arrays the model takes: no "_"-prefixed host metadata, no eval
    records."""
    return {k: v for k, v in batch.items()
            if k not in _EVAL_ONLY_KEYS and not k.startswith("_")}


def _host_labels(batch: Dict[str, Any]) -> np.ndarray:
    """annotation_ids on the host, without waiting for the device (a mesh
    rank's: the whole global batch's)."""
    labels = batch.get("_batch_annotation_ids",
                       batch.get("_host_annotation_ids",
                                 batch["annotation_ids"]))
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    return np.asarray(labels)


def trainer_device(name: str) -> torch.device:
    """The config's ``trainer.device``: "cpu" is the CPU; anything else
    ("tpu" in the reference's file, "gpu", "cuda", "cuda:N") is the card,
    which must exist."""
    if name == "cpu":
        return torch.device("cpu")
    return resolve_device(name if name.startswith("cuda") else "cuda")


def config_compute_dtype(config: Config) -> torch.dtype:
    """bf16 when the model config asks for it or ``mxp_training`` is set."""
    return (torch.bfloat16 if config.model.compute_dtype == "bfloat16"
            or config.trainer.mxp_training else torch.float32)


def prepare_model(model: nn.Module, device: torch.device,
                  compute_dtype: torch.dtype) -> nn.Module:
    """Move ``model`` to ``device``; under bf16 compute hold a frozen tower
    in bf16 (the fused stages repack their operands)."""
    model.to(device)
    if compute_dtype != torch.float32 and "vision_model" in \
            getattr(model, "frozen_modules", lambda: ())():
        model.vision_model.to(compute_dtype)
    return model


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def make_train_step(model: nn.Module, optimizer, scheduler,
                    trainable: List[torch.Tensor],
                    gradient_clipping: Optional[float] = 1.0,
                    compute_dtype: torch.dtype = torch.float32,
                    tp: Optional[TensorParallel] = None):
    """One optimizer step on a device batch -> (loss, argmax predictions),
    both left on the device. The caller puts the model in ``train()``.
    ``tp``: the model axis of a mesh (the clip's norm is the full
    tensors'). Its parts are the ranges ``step.forward``,
    ``step.backward``, ``step.clip`` and ``step.optimizer``."""
    device = next(model.parameters()).device

    def train_step(batch: Dict[str, torch.Tensor]):
        optimizer.zero_grad(set_to_none=True)
        with profiling.span("step.forward"), _autocast(device, compute_dtype):
            log_probs, loss = model(**batch)
        with profiling.span("step.backward"):
            loss.backward()
        if gradient_clipping:
            with profiling.span("step.clip"):
                clip_grad_norm_(trainable, gradient_clipping, tp)
        with profiling.span("step.optimizer"):
            optimizer.step()
            scheduler.step()
        return loss.detach(), log_probs.detach().argmax(-1)

    return train_step


def shard_for_training_(model: nn.Module, mesh: shd.Mesh) -> nn.Module:
    """Split ``model`` over ``mesh`` in place (``shard_model_``) and take its
    frozen parameters out of the gradient: DDP reduces every parameter that
    asks for one."""
    shard_model_(model, mesh)
    labels = label_params(model, frozen_modules=getattr(
        model, "frozen_modules", lambda: ())())
    for name, p in model.named_parameters():
        if labels[name] == FROZEN_LABEL:
            p.requires_grad_(False)
    return model


def setup_train_step(model: nn.Module, config: Config,
                     num_training_steps: int,
                     compute_dtype: torch.dtype = torch.float32,
                     mesh: Optional[shd.Mesh] = None):
    """The optimizer, schedule and train step of ``model`` as the trainer
    builds them from ``config``. Under a ``mesh`` the model is first split
    for training (``shard_for_training_``), the clip and the optimizer
    reduce over the full tensors, and DDP over the data axis wraps the
    stepped model. Returns (optimizer, scheduler, schedules by group, train
    step)."""
    if mesh is not None:
        shard_for_training_(model, mesh)
    tp = TensorParallel.of(mesh)
    optimizer, scheduler, schedules, trainable = build_optimizer(
        model, config.optimizer, config.lr_scheduler, num_training_steps,
        frozen_modules=getattr(model, "frozen_modules", lambda: ())(),
        tp=tp)
    stepped = model
    if mesh is not None and mesh.data > 1:
        from torch.nn.parallel import DistributedDataParallel
        device = next(model.parameters()).device
        stepped = DistributedDataParallel(
            model, process_group=mesh.dp_group,
            device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False)
    step = make_train_step(stepped, optimizer, scheduler, trainable,
                           config.trainer.gradient_clipping, compute_dtype,
                           tp)
    return optimizer, scheduler, schedules, step


def make_eval_step(model: nn.Module,
                   compute_dtype: torch.dtype = torch.float32):
    """A forward on a device batch -> (per-example NLL, argmax predictions),
    so that the host can mask the padding rows of a last partial batch. The
    caller puts the model in ``eval()``."""
    device = next(model.parameters()).device

    def eval_step(batch: Dict[str, torch.Tensor]):
        with torch.inference_mode(), _autocast(device, compute_dtype):
            log_probs, _ = model(**batch)
            per_example = -log_probs.gather(
                -1, batch["annotation_ids"].long()[:, None])[:, 0]
            return per_example, log_probs.argmax(-1)

    return eval_step


def _map_optimizer_state(optimizer, mesh: shd.Mesh,
                         state_dict: Dict[str, Any], fn) -> Dict[str, Any]:
    """``state_dict`` (``optimizer``'s layout) with ``fn(tensor, dim)``
    applied to every state entry split over the model axis
    (``state_split_dim``)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, entries in state_dict["state"].items():
        state[i] = {}
        for key, value in entries.items():
            dim = state_split_dim(optimizer, params[i], key, mesh.model)
            state[i][key] = value if dim is None else fn(value, dim)
    return {**state_dict, "state": state}


def full_optimizer_state(optimizer, mesh: shd.Mesh) -> Dict[str, Any]:
    """A mesh rank's optimizer state in the single-device layout, gathered
    over the model axis (every rank of a model group joins)."""
    return _map_optimizer_state(
        optimizer, mesh, optimizer.state_dict(),
        lambda v, dim: shd.all_gather_cat(v, mesh.tp_group, dim, mesh.model))


def shard_optimizer_state(state_dict: Dict[str, Any], optimizer,
                          mesh: shd.Mesh) -> Dict[str, Any]:
    """A single-device optimizer state -> this rank's share of it."""
    return _map_optimizer_state(
        optimizer, mesh, state_dict,
        lambda v, dim: shd.shard_tensor(v, dim, mesh))


def build_collates(dk: DatasetConfig, answer_spaces: List[str], seed: int,
                   tokenizer=None, family: str = CNN_FAMILY):
    """(train collate, eval collate) of ``family`` from the dataset config,
    as the JAX trainer builds them (the image path of
    ``use_native_preprocessor``, ``uint8_wire_images``, ``reduced_decode``
    and ``num_workers``, seeded answer choice)."""
    kw = dict(lang_model=dk.language_model_tokenizer, seed=seed,
              tokenizer=tokenizer, use_native=dk.use_native_preprocessor,
              emit_uint8=dk.uint8_wire_images,
              reduced_decode=dk.reduced_decode, num_workers=dk.num_workers)
    if family != CNN_FAMILY:
        return (DaquarVitCollate(answer_spaces, **kw),
                DaquarVitCollate(answer_spaces, eval_mode=True, **kw))
    kw["resizing_dimensions"] = (dk.image_size, dk.image_size)
    return (DaquarCnnCollate(answer_spaces, dk.interpolation_strategy, **kw),
            DaquarCnnCollate(answer_spaces, dk.interpolation_strategy,
                             eval_mode=True, **kw))


class VQATrainer:
    """Trains a model of any of the four families on DAQUAR (see the module
    docstring)."""

    def __init__(self, model: nn.Module, config: Config,
                 answer_spaces: List[str], train_dataset=None,
                 test_dataset=None, tokenizer=None,
                 mesh: Optional[shd.Mesh] = None):
        self.config = config
        self.family = model_family(config.model)
        self.answer_spaces = [a.strip("\n") for a in answer_spaces]
        if mesh is not None and not mesh.member:
            raise ValueError("this rank is outside the mesh")
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.is_writer

        tk = config.trainer
        self.device = (mesh.device if mesh is not None
                       else trainer_device(tk.device))
        self.compute_dtype = config_compute_dtype(config)
        self.model = prepare_model(model, self.device, self.compute_dtype)
        self.epochs = tk.epochs
        self.output_dir = tk.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        # dropout draws from torch's generators (all devices); every rank of
        # a mesh seeds them alike and keeps its block of the full masks
        torch.manual_seed(tk.seed)

        self.logger = Logger(self.output_dir, enabled=self.is_writer)
        self.tracker = ExperimentTracker(
            self.output_dir, project=tk.wandb_project,
            config=config.to_dict(), enabled=self.is_writer)
        self.logger.log_message(f"WUPS metric mode: {wups_mode()}")
        if tk.compute_rouge:
            # the card's machine has no nltk: say which scorer runs
            self.logger.log_message(
                "ROUGE stemming: " + ("on (nltk PorterStemmer)"
                                      if stemming_active() else
                                      "off (nltk does not import)"))

        self._init_dataloaders(train_dataset, test_dataset, tokenizer)

        # optimizer + schedule: warmup from the total number of steps; a
        # mesh splits the model here (the resume below loads into it)
        self.num_training_steps = max(1, self.total_train_batch * self.epochs)
        (self.optimizer, self.scheduler, self._schedules,
         self.train_step) = setup_train_step(
            model, config, self.num_training_steps, self.compute_dtype, mesh)
        self._labels = label_params(model, frozen_modules=getattr(
            model, "frozen_modules", lambda: ())())
        self._log_param_table()
        self.global_step = 0
        self.start_epoch = 0
        self.cur_epoch = 0
        self._last_ckpt_step = 0
        # the last epoch whose recovery pair has landed (set by the save
        # worker, read by the loop for max_checkpoint_lag_epochs)
        self._durable_epoch = 0

        cb = config.callbacks
        self.callbacks = EarlyStopping(
            self.logger, self.output_dir,
            save_final_model=cb.save_final_model, patience=cb.patience,
            mode=cb.mode, threshold=cb.threshold)
        if tk.checkpoint_snapshot_budget_mb:
            self.callbacks.ckpt.snapshot_budget_bytes = (
                tk.checkpoint_snapshot_budget_mb * 2 ** 20)
        self.tokenizer_scheme = getattr(
            self.train_dataloader.collate_fn.tokenizer, "scheme", "unknown")
        self.callbacks.tokenizer_scheme = self.tokenizer_scheme
        if mesh is not None:
            self.callbacks.state_fn = self._full_state_dict
            self.callbacks.optimizer_state_fn = \
                lambda optimizer: full_optimizer_state(optimizer, mesh)
            self.callbacks.writer = self.is_writer

        if tk.load_from_checkpoint:
            self._try_resume()

        # after the resume (the features come from the weights that train),
        # before the steps are built
        self._feature_cache = None
        if tk.cache_frozen_features:
            self._setup_feature_cache()

        self._log_startup_summary()
        self.eval_step = make_eval_step(model, self.compute_dtype)

    # ------------------------------------------------------------------ init

    def _init_dataloaders(self, train_dataset, test_dataset, tokenizer):
        dk = self.config.dataset
        if tokenizer is None and dk.tokenizer_file:
            tokenizer = get_tokenizer(dk.language_model_tokenizer,
                                      tokenizer_file=dk.tokenizer_file)
            self.logger.log_message(
                f"Tokenizer: real vocabulary from {dk.tokenizer_file}")
        if dk.dataset_type == "okvqa":
            from ..data.okvqa import OkVqaTrainableDataset
            if train_dataset is None:
                train_dataset = OkVqaTrainableDataset.from_files(
                    dk.root_data_dir, dk.train_annotations_json_fn,
                    dk.train_questions_json_fn, dk.train_images_dir, "train")
            if test_dataset is None:
                test_dataset = OkVqaTrainableDataset.from_files(
                    dk.root_data_dir, dk.test_annotations_json_fn,
                    dk.test_questions_json_fn, dk.test_images_dir, "val")
            self.logger.log_message(
                f"Dataset: OK-VQA (COCO-style), {len(train_dataset)} train / "
                f"{len(test_dataset)} val questions, 10-annotator-answer "
                f"grid -> fresh-answer sampling")
        if train_dataset is None:
            train_dataset = DaquarDataset(dk.root_data_dir, dk.train_csv_file,
                                          dk.images_dir, "train")
        if test_dataset is None:
            test_dataset = DaquarDataset(dk.root_data_dir, dk.test_csv_file,
                                         dk.images_dir, "val")
        seed = self.config.trainer.seed
        train_collate, test_collate = build_collates(
            dk, self.answer_spaces, seed, tokenizer, self.family)
        if dk.adaptive_question_len and self.family == VIT_FAMILY:
            # the ViT family only: its text path reads token 0 of the
            # encoder (pads are masked keys) and the last non-pad decoder
            # position (causal), so trailing pad columns cannot reach the
            # output; the CNN family's SGA reads pad rows unmasked
            self._fit_token_lengths(train_dataset, test_dataset,
                                    [train_collate, test_collate])
        self.train_dataloader = DataLoader(
            train_dataset, train_collate, dk.train_batch_size, shuffle=True,
            seed=seed, drop_remainder=dk.drop_remainder)
        self.test_dataloader = DataLoader(
            test_dataset, test_collate, dk.test_batch_size, shuffle=False,
            drop_remainder=False)
        if self.mesh is not None:
            # every rank reads the same batches and keeps its rows
            self.train_dataloader = shd.ShardedLoader(self.train_dataloader,
                                                      self.mesh)
            self.test_dataloader = shd.ShardedLoader(self.test_dataloader,
                                                     self.mesh)
        self.num_prefetch = dk.num_prefetch_batches
        self.total_train_batch = len(self.train_dataloader)
        self.ten_percent_train_batch = max(
            1, int(self.total_train_batch
                   * self.config.trainer.log_every_fraction))

    def _fit_token_lengths(self, train_dataset, test_dataset, collates):
        """``dataset_kwargs.adaptive_question_len``: the longest question of
        both datasets in tokens, under the collates' tokenizer, becomes the
        collates' question and decoder length (capped at 16 and 20)."""
        tokenizer = collates[0].tokenizer
        q_max, d_max = 1, 1
        for ds in (train_dataset, test_dataset):
            texts = [ds[i].question.question_text for i in range(len(ds))]
            for start in range(0, len(texts), 512):
                chunk = texts[start:start + 512]
                q = [f"{constants.QUESTION_SPECIAL_TOKEN} {t}" for t in chunk]
                d = [f"{constants.QUESTION_SPECIAL_TOKEN} {t} "
                     f"{constants.ANSWER_SPECIAL_TOKEN}" for t in chunk]
                _, qm = tokenizer(q, constants.QUESTION_MAX_LEN)
                _, dm = tokenizer(d, constants.MAX_LEN)
                q_max = max(q_max, int(qm.sum(axis=1).max()))
                d_max = max(d_max, int(dm.sum(axis=1).max()))
        for c in collates:
            c.question_max_len = q_max
            c.decoder_max_len = d_max
        if (q_max, d_max) != (constants.QUESTION_MAX_LEN, constants.MAX_LEN):
            self.logger.log_message(
                f"Adaptive token lengths: question {q_max} (cap "
                f"{constants.QUESTION_MAX_LEN}), decoder {d_max} (cap "
                f"{constants.MAX_LEN}) — trailing pad columns trimmed from "
                f"the compiled shapes (exact math, masked everywhere)")

    def _setup_feature_cache(self):
        """Build the frozen-tower feature cache and put both loaders on it
        (``train/feature_cache.py``); leave it off, with a log line, where
        the model or the data cannot give the same features."""
        model = self.model
        why = None
        if not hasattr(model, "compute_vision_features"):
            why = f"{type(model).__name__} has no separable frozen tower"
        elif not getattr(model, "frozen_modules", lambda: ())():
            why = "vision tower is fine-tuned"
        elif not getattr(model, "vision_tower_deterministic",
                         lambda: True)():
            # the cache is built without dropout; training runs with it
            why = "vision tower has stochastic regularization"
        if why is None:
            try:
                self.train_dataloader.dataset[0].image_path
            except (AttributeError, IndexError):
                why = "dataset rows carry no image_path"
        if why is not None:
            self.logger.log_message(f"Frozen-feature cache: off ({why})")
            return

        datasets = [self.train_dataloader.dataset,
                    self.test_dataloader.dataset]
        collates = [self.train_dataloader.collate_fn,
                    self.test_dataloader.collate_fn]
        # a mesh run keeps the cache on the host, one copy per rank process;
        # each rank copies its rows
        host_mode = self.mesh is not None
        built, reason = build_feature_cache(
            model, datasets, collates[0].load_images,
            batch_size=min(64, max(1, len(datasets[0]))),
            compute_dtype=self.compute_dtype, host_resident=host_mode,
            host_ranks=shd.ranks_on_host(self.mesh) if host_mode else 1)
        if built is None:
            self.logger.log_message(f"Frozen-feature cache: off ({reason})")
            return
        cache, (row_train, row_test), secs = built
        self._feature_cache = cache
        self.train_dataloader = CachedFeatureLoader(self.train_dataloader,
                                                    cache, row_train)
        self.test_dataloader = CachedFeatureLoader(self.test_dataloader,
                                                   cache, row_test)
        for c in collates:
            c.emit_images = False       # no image decoding in any epoch
        where = "host (mesh run)" if host_mode else cache.features.device
        self.logger.log_message(
            f"Frozen-feature cache: {cache.features.shape[0]} images, "
            f"{cache.nbytes / 1e6:.0f} MB {cache.features.dtype} on "
            f"{where}, built in {secs:.1f}s; tower + image "
            f"preprocessing skipped for all epochs")

    def _try_resume(self):
        """Resume as the JAX trainer does: from the ``checkpoint-model`` +
        ``state_dict_checkpoint`` pair when it exists (weights, optimizer
        and scheduler state, epoch and global step, all from one training
        point), else from ``best-model`` weights alone, with a fresh
        optimizer: best-model weights beside an optimizer state from
        another point would mix two training states. A pair without
        ``global_step`` resumes at step 0. The interrupted epoch runs
        again."""
        ck = self.callbacks.ckpt
        info = ck.read_json("model_ckpt_info.json")
        if info is not None:
            saved = info.get("tokenizer_scheme")
            if saved is not None and saved != self.tokenizer_scheme:
                raise ValueError(
                    f"Tokenizer scheme mismatch: checkpoint was trained with "
                    f"{saved!r} but this run tokenizes with "
                    f"{self.tokenizer_scheme!r}. Point dataset_kwargs at the "
                    f"original tokenizer (tokenizer_file / language_model_"
                    f"tokenizer) or start a fresh output_dir.")
            elif saved is None and str(
                    self.tokenizer_scheme).startswith("hash"):
                self.logger.log_message(
                    "WARNING: checkpoint predates tokenizer-scheme metadata; "
                    "if it was trained before hash-v2 answer-space pinning, "
                    "its token ids do not match this run's "
                    f"({self.tokenizer_scheme})")
        paired = ck.exists("checkpoint-model")
        params_name = "checkpoint-model" if paired else "best-model"
        if ck.exists(params_name):
            params = ck.restore_tree(params_name)
            if self.mesh is not None:
                params = shd.shard_state_dict(params, self.mesh)
            self.model.load_state_dict(params, strict=True)
            self.logger.log_line()
            self.logger.log_message(
                "Loaded params from checkpoint-model" if paired
                else "Loaded from Best Model: best-model")
        if not paired and ck.exists("state_dict_checkpoint"):
            self.logger.log_message(
                "Skipping optimizer state restore: state_dict_checkpoint is "
                "paired with checkpoint-model, not best-model")
        if paired and ck.exists("state_dict_checkpoint"):
            state = ck.restore_tree("state_dict_checkpoint")
            # the pair brings the moments (onto the parameters' device, with
            # AMSGrad's max_exp_avg_sq and the step counts) and the
            # schedule's position; this run's config brings the
            # hyperparameters and the schedule, whose length may differ, as
            # the JAX chain is rebuilt around its restored state
            hyper = [{k: v for k, v in g.items() if k != "params"}
                     for g in self.optimizer.param_groups]
            optimizer_state = state["optimizer"]
            if self.mesh is not None:
                optimizer_state = shard_optimizer_state(
                    optimizer_state, self.optimizer, self.mesh)
            self.optimizer.load_state_dict(optimizer_state)
            self.scheduler.load_state_dict(state["scheduler"])
            self.scheduler.base_lrs = [h["initial_lr"] for h in hyper]
            for group, h in zip(self.optimizer.param_groups, hyper):
                group.update(h)
                group["lr"] = self._schedules[h["group"]](
                    self.scheduler.last_epoch)
            self.start_epoch = int(state["epoch"])
            self.global_step = int(state.get("global_step", 0))
            self.logger.log_line()
            self.logger.log_message(
                f"Loaded Optimizer from Checkpoint "
                f"(epoch {self.start_epoch}, step {self.global_step})")
        # the next periodic save counts from the resumed step
        self._last_ckpt_step = self.global_step
        self._durable_epoch = self.start_epoch
        # training_progress.json is written at every epoch end, so it says
        # how far the previous run got beyond the durable pair
        progress = ck.read_json("training_progress.json")
        if progress is not None:
            reached = int(progress.get("epochs_completed", 0))
            if reached > self.start_epoch:
                self.logger.log_message(
                    f"WARNING: resuming at epoch {self.start_epoch} but the "
                    f"previous run completed epoch {reached - 1} — "
                    f"{reached - self.start_epoch} epoch(s) of work will be "
                    f"re-run (the durable checkpoint lagged training; bound "
                    f"this with trainer_kwargs.max_checkpoint_lag_epochs)")
            elif reached:
                self.logger.log_message(
                    f"Resume point is fresh: epoch {self.start_epoch} "
                    f"matches the last completed epoch")

    # ------------------------------------------------------------------ mesh

    def _full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The checkpoint state dict of the full model, gathered over the
        model axis (every rank of a model group joins)."""
        from .callbacks import checkpoint_state_dict
        return shd.gather_state_dict(checkpoint_state_dict(model), self.mesh)

    # --------------------------------------------------------------- logging

    def _log_param_table(self):
        """Names and full shapes (a mesh's split tensors counted whole)."""
        tp = self.mesh.model if self.mesh is not None else 1
        prev = ""
        for name, p in self.model.named_parameters():
            top = name.split(".")[0]
            if top != prev:
                prev = top
                self.logger.log_block("{:<70} {:<30} {:<30} {:<30}".format(
                    "Name", "Weight Shape", "Total Parameters", "Trainable"))
            shape = list(p.shape)
            if tp_dim(p) is not None:
                shape[tp_dim(p)] *= tp
            self.logger.log_message("{:<70} {:<30} {:<30} {:<30}".format(
                name, str(tuple(shape)), int(np.prod(shape)),
                str(self._labels[name] != FROZEN_LABEL)))

    def _log_startup_summary(self):
        cfg = self.config
        dk, tk = cfg.dataset, cfg.trainer
        lg = self.logger
        lg.log_line()
        lg.log_message("Dataloader:")
        lg.log_new_line()
        lg.log_message(f"Root Data Directory: {dk.root_data_dir}")
        lg.log_message(f"Images Directory: {dk.images_dir}")
        lg.log_message(f"Train Dataset: {dk.train_csv_file}")
        lg.log_message(f"Test Dataset: {dk.test_csv_file}")
        lg.log_message(f"Answer Spaces: {dk.answer_spaces_file}")
        lg.log_new_line()
        lg.log_line()
        lg.log_message(f"Optimizer: {cfg.optimizer.type}")
        lg.log_new_line()
        for group, sched in self._schedules.items():
            lg.log_message(f"model_name: {group}")
            lg.log_message("{:<30} {}".format("lr", float(sched(0))))
        lg.log_line()
        lg.log_message("LR Scheduler: linear_schedule_with_warmup")
        lg.log_message("{:<30} {}".format(
            "num_warmup_steps",
            cfg.lr_scheduler.resolve_warmup(self.num_training_steps)))
        lg.log_message("{:<30} {}".format(
            "num_training_steps", self.num_training_steps))
        lg.log_line()
        lg.log_message("Callbacks: EarlyStopping")
        lg.log_new_line()
        lg.log_message("{:<30} {}".format(
            "save_final_model", self.callbacks.save_final_model))
        lg.log_message("{:<30} {}".format("patience", self.callbacks.patience))
        lg.log_message("{:<30} {}".format("threshold",
                                          self.callbacks.threshold))
        lg.log_message("{:<30} {}".format("mode", self.callbacks.mode))
        lg.log_line()
        count = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        name = (f" ({torch.cuda.get_device_name(self.device)})"
                if self.device.type == "cuda" else "")
        lg.log_message(f"Device: {self.device.type}{name} and Device Count: "
                       f"{count}")
        if self.mesh is not None:
            lg.log_message(f"Mesh: {self.mesh.shape}")
        lg.log_message(f"Compute dtype: {self.compute_dtype} (fp32 master "
                       f"weights)")
        lg.log_message(
            f"Not implemented by the port, no effect on the numbers: "
            f"steps_per_dispatch={tk.steps_per_dispatch} (one step per "
            f"call), fast_dropout_rng={tk.fast_dropout_rng} (TPU only), "
            f"use_pallas={cfg.model.use_pallas} (the port's kernels "
            f"are on), use_wandb={tk.use_wandb} (metrics.jsonl only)")
        lg.log_new_line()

    def _current_lrs(self) -> Dict[str, float]:
        return {g: float(s(self.global_step))
                for g, s in self._schedules.items()}

    def _mark_durable(self, epoch: int) -> None:
        # on the save worker, after the pair landed; max keeps it monotonic
        # when a periodic save lands after an epoch-end one
        self._durable_epoch = max(self._durable_epoch, epoch)

    def _enforce_checkpoint_lag_bound(self, epoch_done: int) -> None:
        """Keep the durable recovery point within
        ``max_checkpoint_lag_epochs`` of training: past the bound the loop
        waits for the save queue, trading a stall for a bounded replay
        after a crash (-1: never wait)."""
        bound = self.config.trainer.max_checkpoint_lag_epochs
        if bound < 0:
            return
        lag = epoch_done - self._durable_epoch
        if lag > bound:
            t0 = time.time()
            self.callbacks.ckpt.flush()
            self._durable_epoch = max(self._durable_epoch, epoch_done)
            self.logger.log_message(
                f"Checkpoint lag reached {lag} epoch(s) > "
                f"max_checkpoint_lag_epochs={bound}; drained the save queue "
                f"(blocked {time.time() - t0:.1f}s) — durable resume point "
                f"is now epoch {self._durable_epoch}")

    def _save_pair(self, epoch: int) -> None:
        """Submit the recovery pair; ``epoch`` is the epoch a resume runs
        first."""
        self.callbacks.save_epoch_checkpoint(
            self.model, epoch, self.optimizer, self.scheduler,
            self.global_step,
            on_complete=lambda: self._mark_durable(epoch))
        self._last_ckpt_step = self.global_step

    # ------------------------------------------------------------------ train

    def train(self):
        self.logger.log_line()
        self.logger.log_message(f"Start Training: Max Epoch {self.epochs}")
        self.logger.log_new_line()
        self.total_training_time = 0.0
        try:
            for epoch in range(self.start_epoch, self.epochs):
                self.cur_epoch = epoch
                self.logger.log_line()
                self.train_one_epoch()
                if (self.config.trainer.monitor_test
                        and epoch >= self.config.trainer.first_val_epoch):
                    self.valid_one_epoch()
                # epoch + 1: the next epoch to run on resume
                self._save_pair(epoch + 1)
                # a synchronous record of how far this run got; the resume
                # reads it to report replayed work after a crash
                if self.is_writer:
                    self.callbacks.ckpt.write_json(
                        "training_progress.json",
                        {"epochs_completed": epoch + 1,
                         "global_step": self.global_step})
                self.logger.sync()
                self._enforce_checkpoint_lag_bound(epoch + 1)
                if self.callbacks.should_stop:
                    self.logger.log_message(
                        f"Early stopping after {epoch + 1} epochs "
                        f"(patience {self.callbacks.patience})")
                    break
        except KeyboardInterrupt:
            self.callbacks.exit_training(self.model)     # flushes first
            self.logger.log_line()
            self.logger.log_message(
                "Exiting Training due to Keyboard Interrupt")
            self.tracker.finish()
            return
        # land every background save before train() returns: callers may
        # read the files at once
        self.callbacks.ckpt.flush()
        superseded = self.callbacks.ckpt.superseded_saves
        if superseded:
            self.logger.log_message(
                f"Checkpoint worker superseded {superseded} queued save(s) "
                f"with newer state (save slower than epoch cadence)")
        self.tracker.finish()

    def train_one_epoch(self):
        """One epoch of steps. Losses and predictions stay on the device;
        the host reads them once per logged window (every step for an
        epoch under 10 batches) and at the epoch's end. With ``trace_dir``,
        epoch 0's steps run under the profiler."""
        tk = self.config.trainer
        with (profiling.trace(tk.trace_dir)
              if tk.trace_dir and self.cur_epoch == 0 and self.is_writer
              else contextlib.nullcontext()):
            train_targets, pred_chunks, total_loss, epoch_time = \
                self._run_steps()
        self._end_train_epoch(train_targets, pred_chunks, total_loss,
                              epoch_time)

    def _run_steps(self):
        """The epoch's steps -> (targets, device prediction chunks, summed
        loss, epoch time)."""
        self.model.train()
        tiny = self.total_train_batch < 10
        total_loss = 0.0
        epoch_time = 0.0
        window: List[torch.Tensor] = []
        pred_chunks: List[torch.Tensor] = []
        train_targets: List[int] = []
        next_log = self.ten_percent_train_batch
        window_t0 = time.time()
        batch_idx = -1
        for raw in Prefetcher(self.train_dataloader, self.num_prefetch,
                              self.device):
            train_targets.extend(_host_labels(raw).tolist())
            loss, preds = self.train_step(_device_batch(raw))
            window.append(loss)
            pred_chunks.append(preds)
            self.global_step += 1
            batch_idx += 1
            ck_every = self.config.trainer.checkpoint_every_steps
            if ck_every and self.global_step - self._last_ckpt_step \
                    >= ck_every:
                # a resume runs the interrupted epoch again
                self._save_pair(self.cur_epoch)
            if tiny:
                total_loss += float(self._mean_losses(window).sum())
                window.clear()
                self.logger.log_message(
                    f"Epoch: {self.cur_epoch} - iteration "
                    f"{batch_idx}/{self.total_train_batch} - total loss "
                    f"{total_loss:.4f}")
            elif batch_idx + 1 >= next_log:
                next_log += self.ten_percent_train_batch
                s = float(self._mean_losses(window).sum())
                n = len(window)
                window.clear()
                total_loss += s
                dt = time.time() - window_t0
                window_t0 = time.time()
                epoch_time += dt
                log_lrs = "".join(f" - {g} lr: {lr:.2e}"
                                  for g, lr in self._current_lrs().items())
                self.logger.log_message(
                    f"Epoch {self.cur_epoch} - iter "
                    f"{batch_idx}/{self.total_train_batch} - total loss "
                    f"{s / n:.4f}{log_lrs} - secs/batch "
                    f"{convert_time_to_readable_format(round(dt / n, 4))}")
        if window:
            total_loss += float(self._mean_losses(window).sum())
        epoch_time += time.time() - window_t0
        return train_targets, pred_chunks, total_loss, epoch_time

    def _mean_losses(self, window: List[torch.Tensor]) -> torch.Tensor:
        """The window's step losses; under a mesh averaged over the data
        axis (row means of equal shards: the global batch's mean)."""
        losses = torch.stack(window)
        if self.mesh is not None:
            losses = shd.mean_over_data(losses, self.mesh)
        return losses

    def _gather_rows(self, chunks: List[torch.Tensor]) -> torch.Tensor:
        """[steps, rows] from per-step chunks; under a mesh each step's
        rows of the whole global batch, in order."""
        stacked = torch.stack(chunks)
        if self.mesh is not None and self.mesh.data > 1:
            stacked = shd.all_gather_cat(stacked, self.mesh.dp_group, 1,
                                         self.mesh.data)
        return stacked

    def _end_train_epoch(self, train_targets, pred_chunks, total_loss,
                         epoch_time):
        train_predictions = (self._gather_rows(pred_chunks).flatten().cpu()
                             .tolist() if pred_chunks else [])
        self.total_training_time += epoch_time
        avg_epoch_loss = total_loss / max(1, self.total_train_batch)
        avg_wups = 0.0
        if self.is_writer:
            preds_text = [self.answer_spaces[p] for p in train_predictions]
            targets_text = [self.answer_spaces[t] for t in train_targets]
            avg_wups = average_wups(preds_text, targets_text)

        self.logger.log_line()
        self.logger.log_message(
            f"Epoch #{self.cur_epoch}: Average Loss {avg_epoch_loss} - "
            f"Average WUPS Score: {avg_wups:.4f} - Epoch Training Time: "
            f"{convert_time_to_readable_format(round(epoch_time, 4))} - "
            f"Total Training Time: "
            f"{convert_time_to_readable_format(round(self.total_training_time, 4))}")
        self.tracker.log({
            "epoch": self.cur_epoch,
            "train_avg_loss": avg_epoch_loss,
            "train_avg_wups": avg_wups,
        })

    # ------------------------------------------------------------------- eval

    def valid_one_epoch(self):
        self.model.eval()
        valid_targets: List[int] = []
        valid_questions: List[Any] = []
        loss_chunks: List[torch.Tensor] = []
        pred_chunks: List[torch.Tensor] = []
        valid_counts: List[int] = []
        for raw in Prefetcher(self.test_dataloader, self.num_prefetch,
                              self.device):
            labels = _host_labels(raw)
            valid = int(raw.get("_valid", len(labels)))
            valid_questions.extend(raw["questions"][:valid])
            loss, preds = self.eval_step(_device_batch(raw))
            loss_chunks.append(loss)
            pred_chunks.append(preds)
            valid_counts.append(valid)
            valid_targets.extend(labels[:valid].tolist())

        valid_predictions: List[int] = []
        total_valid_loss = 0.0
        if pred_chunks:
            # the padding rows of a last partial batch are left out
            losses = self._gather_rows(loss_chunks)
            preds = self._gather_rows(pred_chunks)
            valid_predictions = torch.cat(
                [p[:n] for p, n in zip(preds, valid_counts)]).cpu().tolist()
            total_valid_loss = float(torch.cat(
                [x[:n] for x, n in zip(losses, valid_counts)]).double().sum())
        total_valid_count = sum(valid_counts)

        predictions_dict_list = []
        wups_scores = []
        # rank 0 scores a mesh run once and hands the others the score
        scored = valid_predictions if self.is_writer else []
        for pred, target, question in zip(scored, valid_targets,
                                          valid_questions):
            pred_text = self.answer_spaces[pred]
            target_text = self.answer_spaces[target]
            score = wup_measure(pred_text, target_text)
            wups_scores.append(score)
            predictions_dict_list.append({
                "question_text": question.question_text,
                "prediction": pred_text,
                "target": target_text,
                "wups_score": score,
            })
        avg_wups = (sum(wups_scores) / len(wups_scores)) if wups_scores else 0.0
        if self.mesh is not None:
            avg_wups = shd.broadcast_object(avg_wups, self.mesh)
        avg_valid_loss = total_valid_loss / max(1, total_valid_count)

        rouge_overall = None
        if self.config.trainer.compute_rouge and scored:
            _, rouge_overall = compute_rouge_metric(
                valid_predictions, valid_targets, self.answer_spaces)

        self.callbacks(self.model, avg_wups, self.cur_epoch,
                       self.answer_spaces)

        self.logger.log_line()
        self.logger.log_message(
            f"Epoch #{self.cur_epoch}: Average Validation Loss: "
            f"{avg_valid_loss:.4f} - Average WUPS Score: {avg_wups:.4f}")
        if rouge_overall is not None:
            self.logger.log_message(
                "Validation ROUGE: " + " - ".join(
                    f"{k} f={v['fmeasure']:.4f}"
                    for k, v in rouge_overall.items()))
        self.logger.log_new_line()

        if self.is_writer:
            pred_dir = os.path.join(self.output_dir, "validation_predictions")
            os.makedirs(pred_dir, exist_ok=True)
            with open(os.path.join(
                    pred_dir, f"{self.cur_epoch}_validation_predictions.json"),
                    "w") as f:
                json.dump(predictions_dict_list, f)

        metrics = {
            "epoch": self.cur_epoch,
            "valid_avg_loss": avg_valid_loss,
            "valid_avg_wups": avg_wups,
        }
        if rouge_overall is not None:
            metrics.update({f"valid_{k}_f": v["fmeasure"]
                            for k, v in rouge_overall.items()})
        self.tracker.log(metrics)
        self.last_valid_wups = avg_wups
        self.last_valid_loss = avg_valid_loss

    # ------------------------------------------------------------ convenience

    @classmethod
    def from_config(cls, config: Config, tokenizer=None,
                    generator: Optional[torch.Generator] = None,
                    mesh: Optional[shd.Mesh] = None):
        """Read the answer space and build the model from ``config``
        (random weights from ``generator``; default seeded with 0, the same
        on every rank of a ``mesh``)."""
        dk = config.dataset
        answer_spaces = load_answer_spaces(
            os.path.join(dk.root_data_dir, dk.answer_spaces_file))
        if config.trainer.mxp_training:
            config.model.compute_dtype = "bfloat16"
        device = (mesh.device if mesh is not None
                  else trainer_device(config.trainer.device))
        model, _ = build_model(config.model, len(answer_spaces),
                               device=device, generator=generator)
        return cls(model, config, answer_spaces, tokenizer=tokenizer,
                   mesh=mesh)


def train_rank(rank: int, config: Config, shape) -> None:
    """One rank of a mesh run of the entry points (``parallel/launch.py``
    calls it in each rank's process): the mesh of ``shape`` and a trainer
    on it."""
    from ..parallel import make_mesh
    VQATrainer.from_config(config, mesh=make_mesh(*shape)).train()
