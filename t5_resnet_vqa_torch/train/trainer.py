"""The VQA trainer for the CNN and the ViT families.

PyTorch counterpart of ``VQATrainer`` and ``make_train_step`` of the JAX
package's ``train/trainer.py``, with its log lines and artifacts:

  * startup: WUPS mode, the parameter table, the dataloader summary, the
    optimizer groups, the scheduler and the callbacks;
  * per epoch: step logs (every step for epochs under 10 batches, else
    every 10% with per-group LRs and secs/batch), the epoch's train WUPS,
    then validation: loss, WUPS, best-model checkpoint and
    ``validation_predictions/<epoch>_validation_predictions.json``;
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

The family decides only the collate (``DaquarCnnCollate`` or
``DaquarVitCollate``) and, for the ViT family, the adaptive token lengths
(``dataset_kwargs.adaptive_question_len``): the question and decoder
lengths shrink to the longest tokenized question of the two datasets, which
changes no number (trailing pad columns are masked everywhere in that
family). The steps are family-blind. With ``cache_frozen_features`` (the
reference config's setting) a frozen tower runs once per unique image
before the first epoch (``train/feature_cache.py``), and the steps take the
gathered ``vision_features`` in place of the images.

Knobs of the JAX trainer that change nothing in the numbers are named in
one startup log line and otherwise ignored; knobs that would change what
is computed or written raise ``NotImplementedError`` naming the ROADMAP
item that brings them.
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
    load_answer_spaces,
)
from ..eval.wups import average_wups, wup_measure, wups_mode
from ..utils.time_utils import convert_time_to_readable_format
from .callbacks import EarlyStopping
from .factory import CNN_FAMILY, VIT_FAMILY, build_model, model_family
from .feature_cache import CachedFeatureLoader, build_feature_cache
from .optimizer import FROZEN_LABEL, build_optimizer, label_params

_EVAL_ONLY_KEYS = ("answers", "questions", "image_fns")


def _device_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The arrays the model takes: no "_"-prefixed host metadata, no eval
    records."""
    return {k: v for k, v in batch.items()
            if k not in _EVAL_ONLY_KEYS and not k.startswith("_")}


def _host_labels(batch: Dict[str, Any]) -> np.ndarray:
    """annotation_ids on the host, without waiting for the device."""
    labels = batch.get("_host_annotation_ids", batch["annotation_ids"])
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
                    compute_dtype: torch.dtype = torch.float32):
    """One optimizer step on a device batch -> (loss, argmax predictions),
    both left on the device. The caller puts the model in ``train()``."""
    device = next(model.parameters()).device

    def train_step(batch: Dict[str, torch.Tensor]):
        optimizer.zero_grad(set_to_none=True)
        with _autocast(device, compute_dtype):
            log_probs, loss = model(**batch)
        loss.backward()
        if gradient_clipping:
            torch.nn.utils.clip_grad_norm_(trainable, gradient_clipping)
        optimizer.step()
        scheduler.step()
        return loss.detach(), log_probs.detach().argmax(-1)

    return train_step


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


def build_collates(dk: DatasetConfig, answer_spaces: List[str], seed: int,
                   tokenizer=None, family: str = CNN_FAMILY):
    """(train collate, eval collate) of ``family`` from the dataset config,
    as the JAX trainer builds them (cv2 image path, seeded answer choice)."""
    kw = dict(lang_model=dk.language_model_tokenizer, seed=seed,
              tokenizer=tokenizer, emit_uint8=dk.uint8_wire_images)
    if family == VIT_FAMILY:
        return (DaquarVitCollate(answer_spaces, **kw),
                DaquarVitCollate(answer_spaces, eval_mode=True, **kw))
    kw["resizing_dimensions"] = (dk.image_size, dk.image_size)
    return (DaquarCnnCollate(answer_spaces, dk.interpolation_strategy, **kw),
            DaquarCnnCollate(answer_spaces, dk.interpolation_strategy,
                             eval_mode=True, **kw))


def _refuse_unported(config: Config) -> None:
    """Raise on the knobs whose JAX behaviour the port does not have and
    that would change what is computed or written."""
    tk, dk = config.trainer, config.dataset
    refused = [
        (tk.checkpoint_every_steps > 0, "trainer_kwargs.checkpoint_every_steps"
         " > 0 (periodic checkpoint pairs: ROADMAP.md, modules item 7)"),
        (tk.compute_rouge, "trainer_kwargs.compute_rouge (ROUGE: ROADMAP.md, "
         "modules item 8)"),
        (bool(tk.trace_dir), "trainer_kwargs.trace_dir (the trainer's "
         "profiler trace: ROADMAP.md, modules item 7)"),
        (dk.reduced_decode != 0, "dataset_kwargs.reduced_decode (reduced "
         "image decoding: ROADMAP.md, modules item 12)"),
        (bool(dk.tokenizer_file), "dataset_kwargs.tokenizer_file (the "
         "tokenizer.json tokenizer: ROADMAP.md, modules item 6)"),
        (dk.dataset_type != "daquar", f"dataset_kwargs.dataset_type="
         f"{dk.dataset_type!r} (OK-VQA: ROADMAP.md, modules item 12)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"the port does not implement {what}")


class VQATrainer:
    """Trains a CNN- or ViT-family model on DAQUAR (see the module
    docstring)."""

    def __init__(self, model: nn.Module, config: Config,
                 answer_spaces: List[str], train_dataset=None,
                 test_dataset=None, tokenizer=None):
        _refuse_unported(config)
        self.config = config
        self.family = model_family(config.model)
        if self.family not in (CNN_FAMILY, VIT_FAMILY):
            raise NotImplementedError(
                f"the port trains the {CNN_FAMILY!r} and {VIT_FAMILY!r} "
                f"families, not {self.family!r} (ROADMAP.md, modules "
                f"item 11)")
        self.answer_spaces = [a.strip("\n") for a in answer_spaces]

        tk = config.trainer
        self.device = trainer_device(tk.device)
        self.compute_dtype = (
            torch.bfloat16 if config.model.compute_dtype == "bfloat16"
            or tk.mxp_training else torch.float32)
        self.model = prepare_model(model, self.device, self.compute_dtype)
        self.epochs = tk.epochs
        self.output_dir = tk.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        # dropout draws from torch's generators (all devices)
        torch.manual_seed(tk.seed)

        self.logger = Logger(self.output_dir)
        self.tracker = ExperimentTracker(
            self.output_dir, project=tk.wandb_project,
            config=config.to_dict())
        self.logger.log_message(f"WUPS metric mode: {wups_mode()}")

        self._init_dataloaders(train_dataset, test_dataset, tokenizer)

        frozen = getattr(model, "frozen_modules", lambda: ())()
        self._labels = label_params(model, frozen_modules=frozen)
        self._log_param_table()

        # optimizer + schedule: warmup from the total number of steps
        self.num_training_steps = max(1, self.total_train_batch * self.epochs)
        (self.optimizer, self.scheduler, self._schedules,
         trainable) = build_optimizer(
            model, config.optimizer, config.lr_scheduler,
            self.num_training_steps, frozen_modules=frozen)
        self.global_step = 0
        self.start_epoch = 0
        self.cur_epoch = 0

        cb = config.callbacks
        self.callbacks = EarlyStopping(
            self.logger, self.output_dir,
            save_final_model=cb.save_final_model, patience=cb.patience,
            mode=cb.mode, threshold=cb.threshold)
        self.tokenizer_scheme = getattr(
            self.train_dataloader.collate_fn.tokenizer, "scheme", "unknown")
        self.callbacks.tokenizer_scheme = self.tokenizer_scheme

        if tk.load_from_checkpoint:
            self._try_resume()

        # after the resume (the features come from the weights that train),
        # before the steps are built
        self._feature_cache = None
        if tk.cache_frozen_features:
            self._setup_feature_cache()

        self._log_startup_summary()
        self.train_step = make_train_step(
            model, self.optimizer, self.scheduler, trainable,
            tk.gradient_clipping, self.compute_dtype)
        self.eval_step = make_eval_step(model, self.compute_dtype)

    # ------------------------------------------------------------------ init

    def _init_dataloaders(self, train_dataset, test_dataset, tokenizer):
        dk = self.config.dataset
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
        built, reason = build_feature_cache(
            model, datasets, collates[0].load_images,
            batch_size=min(64, max(1, len(datasets[0]))),
            compute_dtype=self.compute_dtype)
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
        self.logger.log_message(
            f"Frozen-feature cache: {cache.features.shape[0]} images, "
            f"{cache.nbytes / 1e6:.0f} MB {cache.features.dtype} on "
            f"{cache.features.device}, built in {secs:.1f}s; tower + image "
            f"preprocessing skipped for all epochs")

    def _try_resume(self):
        """Load the best model's weights, as the JAX trainer does when only
        ``best-model`` exists: weights only, no optimizer state, from
        epoch 0 (the epoch checkpoint pair is not ported yet)."""
        ck = self.callbacks.ckpt
        info = ck.read_json("model_ckpt_info.json")
        saved = None if info is None else info.get("tokenizer_scheme")
        if saved is not None and saved != self.tokenizer_scheme:
            raise ValueError(
                f"Tokenizer scheme mismatch: checkpoint was trained with "
                f"{saved!r} but this run tokenizes with "
                f"{self.tokenizer_scheme!r}; start a fresh output_dir.")
        if ck.exists("best-model.pt"):
            self.model.load_state_dict(ck.load_model("best-model.pt"),
                                       strict=True)
            self.logger.log_line()
            self.logger.log_message("Loaded from Best Model: best-model")

    # --------------------------------------------------------------- logging

    def _log_param_table(self):
        prev = ""
        for name, p in self.model.named_parameters():
            top = name.split(".")[0]
            if top != prev:
                prev = top
                self.logger.log_block("{:<70} {:<30} {:<30} {:<30}".format(
                    "Name", "Weight Shape", "Total Parameters", "Trainable"))
            self.logger.log_message("{:<70} {:<30} {:<30} {:<30}".format(
                name, str(tuple(p.shape)), p.numel(),
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
        lg.log_message(f"Compute dtype: {self.compute_dtype} (fp32 master "
                       f"weights)")
        lg.log_message(
            f"Not implemented by the port, no effect on the numbers: "
            f"steps_per_dispatch={tk.steps_per_dispatch} (one step per "
            f"call), fast_dropout_rng={tk.fast_dropout_rng} (TPU only), "
            f"num_workers={dk.num_workers}, "
            f"use_native_preprocessor={dk.use_native_preprocessor} (the cv2 "
            f"path), use_pallas={cfg.model.use_pallas} (the port's kernels "
            f"are on), use_wandb={tk.use_wandb} (metrics.jsonl only)")
        lg.log_new_line()

    def _current_lrs(self) -> Dict[str, float]:
        return {g: float(s(self.global_step))
                for g, s in self._schedules.items()}

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
                self.logger.sync()
                if self.callbacks.should_stop:
                    self.logger.log_message(
                        f"Early stopping after {epoch + 1} epochs "
                        f"(patience {self.callbacks.patience})")
                    break
        except KeyboardInterrupt:
            self.callbacks.exit_training(self.model)
            self.logger.log_line()
            self.logger.log_message(
                "Exiting Training due to Keyboard Interrupt")
            self.tracker.finish()
            return
        self.tracker.finish()

    def train_one_epoch(self):
        """One epoch of steps. Losses and predictions stay on the device;
        the host reads them once per logged window (every step for an
        epoch under 10 batches) and at the epoch's end."""
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
            if tiny:
                total_loss += float(torch.stack(window).sum())
                window.clear()
                self.logger.log_message(
                    f"Epoch: {self.cur_epoch} - iteration "
                    f"{batch_idx}/{self.total_train_batch} - total loss "
                    f"{total_loss:.4f}")
            elif batch_idx + 1 >= next_log:
                next_log += self.ten_percent_train_batch
                s = float(torch.stack(window).sum())
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
            total_loss += float(torch.stack(window).sum())
        epoch_time += time.time() - window_t0

        train_predictions = (torch.cat(pred_chunks).cpu().tolist()
                             if pred_chunks else [])
        self.total_training_time += epoch_time
        avg_epoch_loss = total_loss / max(1, self.total_train_batch)
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
            loss_chunks.append(loss[:valid])
            pred_chunks.append(preds[:valid])
            valid_counts.append(valid)
            valid_targets.extend(labels[:valid].tolist())

        valid_predictions: List[int] = []
        total_valid_loss = 0.0
        if pred_chunks:
            valid_predictions = torch.cat(pred_chunks).cpu().tolist()
            total_valid_loss = float(torch.cat(loss_chunks).double().sum())
        total_valid_count = sum(valid_counts)

        predictions_dict_list = []
        wups_scores = []
        for pred, target, question in zip(valid_predictions, valid_targets,
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
        avg_valid_loss = total_valid_loss / max(1, total_valid_count)

        self.callbacks(self.model, avg_wups, self.cur_epoch,
                       self.answer_spaces)

        self.logger.log_line()
        self.logger.log_message(
            f"Epoch #{self.cur_epoch}: Average Validation Loss: "
            f"{avg_valid_loss:.4f} - Average WUPS Score: {avg_wups:.4f}")
        self.logger.log_new_line()

        pred_dir = os.path.join(self.output_dir, "validation_predictions")
        os.makedirs(pred_dir, exist_ok=True)
        with open(os.path.join(
                pred_dir,
                f"{self.cur_epoch}_validation_predictions.json"), "w") as f:
            json.dump(predictions_dict_list, f)

        self.tracker.log({
            "epoch": self.cur_epoch,
            "valid_avg_loss": avg_valid_loss,
            "valid_avg_wups": avg_wups,
        })
        self.last_valid_wups = avg_wups
        self.last_valid_loss = avg_valid_loss

    # ------------------------------------------------------------ convenience

    @classmethod
    def from_config(cls, config: Config, tokenizer=None,
                    generator: Optional[torch.Generator] = None):
        """Read the answer space and build the model from ``config``
        (random weights from ``generator``; default seeded with 0)."""
        dk = config.dataset
        answer_spaces = load_answer_spaces(
            os.path.join(dk.root_data_dir, dk.answer_spaces_file))
        if config.trainer.mxp_training:
            config.model.compute_dtype = "bfloat16"
        model, _ = build_model(config.model, len(answer_spaces),
                               device=trainer_device(config.trainer.device),
                               generator=generator)
        return cls(model, config, answer_spaces, tokenizer=tokenizer)
