"""File + stdout logger and experiment tracking.

A copy of the JAX package's ``core/logging.py``: ``Logger`` writes a
timestamped ``training_log_<ts>.txt`` in the output directory, mirrored to
stdout, with the reference logger's log_message / log_line / log_new_line /
log_block surface; ``ExperimentTracker`` appends the same records to
``<output_dir>/metrics.jsonl``. The port keeps the metrics stream local
(the JAX tracker may also drive wandb; the trainer names ``use_wandb`` among
the knobs it ignores).
"""

from __future__ import annotations

import json
import logging as _logging
import os
import sys
import time
from typing import Any, Dict, Optional


class Logger:
    """stdlib-logging based file+stdout logger. ``enabled=False`` (the ranks
    of a mesh other than 0) writes nothing anywhere."""

    def __init__(self, output_dir: str, name: str = "t5_resnet_vqa_torch",
                 enabled: bool = True):
        ts = time.strftime("%Y-%m-%d_%H-%M-%S")
        self.log_path = os.path.join(output_dir, f"training_log_{ts}.txt")

        self._logger = _logging.getLogger(f"{name}.{ts}.{id(self)}")
        self._logger.setLevel(_logging.INFO)
        self._logger.propagate = False
        self._file_handler = None
        if not enabled:
            self._logger.addHandler(_logging.NullHandler())
            return
        os.makedirs(output_dir, exist_ok=True)

        fh = _logging.FileHandler(self.log_path)
        fh.setFormatter(_logging.Formatter("%(asctime)s %(message)s"))
        sh = _logging.StreamHandler(sys.stdout)
        sh.setFormatter(_logging.Formatter("%(message)s"))
        self._logger.addHandler(fh)
        self._logger.addHandler(sh)
        self._file_handler = fh

    def sync(self) -> None:
        """Flush and fsync the log file (once per epoch), so that the log is
        at most one epoch behind the checkpoints."""
        if self._file_handler is None:
            return
        stream = self._file_handler.stream
        try:
            stream.flush()
            os.fsync(stream.fileno())
        except (OSError, ValueError):   # closed stream — nothing to sync
            pass

    def log_message(self, message: str) -> None:
        self._logger.info(message)

    def log_line(self, width: int = 100) -> None:
        self._logger.info("-" * width)

    def log_new_line(self) -> None:
        self._logger.info("")

    def log_block(self, message: str) -> None:
        self.log_line()
        self._logger.info(message)
        self.log_line()


class ExperimentTracker:
    """Metrics records in ``<output_dir>/metrics.jsonl``: init(config) /
    log(dict) / finish(), each record flushed and fsynced; nothing with
    ``enabled=False``."""

    def __init__(self, output_dir: str, project: str,
                 config: Optional[Dict[str, Any]] = None,
                 enabled: bool = True):
        self.project = project
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._step = 0
        self._fh = None
        if not enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._fh = open(self.path, "a")
        if config is not None:
            self._emit({"_event": "init", "project": project, "config": config})

    def _emit(self, record: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        record = dict(record)
        record.setdefault("_time", time.time())
        self._fh.write(json.dumps(record, default=str) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def log(self, metrics: Dict[str, Any]) -> None:
        self._step += 1
        self._emit({"_event": "log", "_step": self._step, **metrics})

    def finish(self) -> None:
        self._emit({"_event": "finish"})
        if self._fh is not None:
            self._fh.close()
