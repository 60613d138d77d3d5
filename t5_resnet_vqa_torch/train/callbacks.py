"""Callbacks: best-model checkpointing and early stopping.

PyTorch counterpart of ``Callbacks`` and ``EarlyStopping`` of the JAX
package's ``train/callbacks.py``, with the reference's artifacts under
``<output_dir>/model_checkpoints/``:

  best-model.pt           the model's ``state_dict`` (the reference's keys,
                          fp32), on a validation-score improvement
  model_ckpt_info.json    {epoch, best_score, answer_spaces, tokenizer_scheme}
  model-metrics.json      {best-score}, read back on resume
  final-model.pt          on an interrupt, with ``save_final_model``

Each file is written to a temporary name, fsynced and moved into place
with ``os.replace``; the two JSON files are written only after the
checkpoint they describe has landed. Patience is honoured: ``should_stop``
goes True after ``patience`` epochs without improvement.

Not ported yet: the epoch-end ``checkpoint-model`` + ``state_dict_checkpoint``
pair and its crash recovery (``CheckpointManager``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..core.logging import Logger


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, write: Callable[[Any], None],
                  mode: str = "wb") -> None:
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def checkpoint_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` on the CPU, floating tensors in fp32 (a
    tower held in bf16 is saved exactly, widened)."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach()
                ).cpu() for k, v in model.state_dict().items()}


class CheckpointStore:
    """The ``model_checkpoints`` directory: atomic writes of state dicts and
    JSON records."""

    def __init__(self, output_dir: str):
        self.output_dir = os.path.join(output_dir, "model_checkpoints")
        os.makedirs(self.output_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    def save_model(self, name: str, model: nn.Module) -> None:
        state = checkpoint_state_dict(model)
        _write_atomic(self.path(name), lambda f: torch.save(state, f))

    def load_model(self, name: str) -> Dict[str, torch.Tensor]:
        return torch.load(self.path(name), map_location="cpu",
                          weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def write_json(self, name: str, obj: Any) -> None:
        _write_atomic(self.path(name), lambda f: json.dump(obj, f), "w")

    def read_json(self, name: str) -> Optional[Any]:
        if not self.exists(name):
            return None
        with open(self.path(name)) as f:
            return json.load(f)


class Callbacks:
    """Base: best-model saving."""

    def __init__(self, logger: Logger, output_dir: str,
                 save_final_model: bool = False):
        self.logger = logger
        self.save_final_model = save_final_model
        self.ckpt = CheckpointStore(output_dir)
        self.best_score = 0.0
        self.mode = "max"
        self.threshold = 0.0
        # id layout of the tokenizer the weights were trained with
        self.tokenizer_scheme: Optional[str] = None

    def better_score(self, score: float) -> bool:
        if self.mode == "max":
            return (score - self.best_score) > self.threshold
        return (self.best_score - score) > self.threshold

    def save_checkpoint(self, model: nn.Module, epoch: int,
                        answer_spaces: List[str]) -> None:
        self.logger.log_message(
            f"Saving new best-model with F-Score: {self.best_score:.4f}")
        self.ckpt.save_model("best-model.pt", model)
        self.ckpt.write_json("model_ckpt_info.json", {
            "epoch": epoch,
            "best_score": self.best_score,
            "answer_spaces": list(answer_spaces),
            "tokenizer_scheme": self.tokenizer_scheme,
        })

    def exit_training(self, model: nn.Module) -> None:
        self.logger.log_block(
            f"Exiting from training early. Best model score: "
            f"{self.best_score:.4f}. Saving final model: "
            f"{self.save_final_model} ")
        if self.save_final_model:
            self.logger.log_message("Saving model ...")
            self.ckpt.save_model("final-model.pt", model)
            self.logger.log_message("Done.")


class EarlyStopping(Callbacks):
    """Patience/threshold early stopping."""

    def __init__(self, logger: Logger, output_dir: str,
                 save_final_model: bool = False, patience: int = 5,
                 mode: str = "max", threshold: float = 0.01):
        super().__init__(logger, output_dir, save_final_model)
        self.patience = patience
        self.mode = mode
        self.threshold = threshold
        self.best_score = 0.0 if mode == "max" else float("inf")
        self.num_bad_epoch = 0
        self.should_stop = False

        metrics = self.ckpt.read_json("model-metrics.json")
        if metrics is not None:                      # resume
            self.best_score = metrics["best-score"]

    def __call__(self, model: nn.Module, score: float, epoch: int,
                 answer_spaces: List[str]) -> None:
        if self.better_score(score):
            self.best_score = score
            self.num_bad_epoch = 0
            self.save_checkpoint(model, epoch, answer_spaces)
            self.ckpt.write_json("model-metrics.json", {"best-score": score})
        else:
            self.num_bad_epoch += 1
            self.logger.log_new_line()
            self.logger.log_message(
                f"Bad Epoch. Total num bad epoch: {self.num_bad_epoch}")
            if self.num_bad_epoch >= self.patience:
                self.should_stop = True
