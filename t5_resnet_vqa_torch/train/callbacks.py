"""Callbacks: checkpointing and early stopping.

PyTorch counterpart of ``CheckpointManager``, ``Callbacks`` and
``EarlyStopping`` of the JAX package's ``train/callbacks.py``, with the
reference's artifacts under ``<output_dir>/model_checkpoints/`` as
``torch.save`` files:

  best-model.pt             the model's ``state_dict`` (the reference's keys,
                            fp32) on a validation-score improvement
  model_ckpt_info.json      {epoch, best_score, answer_spaces, tokenizer_scheme}
  checkpoint-model.pt       the model's ``state_dict`` at the last epoch end
                            (or periodic save)
  state_dict_checkpoint.pt  {epoch, global_step, optimizer, scheduler} from
                            the same training point
  final-model.pt            on an interrupt, with ``save_final_model``
  model-metrics.json        {best-score}, read back on resume

A checkpoint is written to ``<name>.pt.next`` (through a ``.tmp`` file,
fsynced, so a ``.next`` that exists is complete) and then moved into place
with ``os.replace``. ``checkpoint-model`` and ``state_dict_checkpoint`` are
one pair: both ``.next`` files land before either is moved, and recovery
throws away a lone params ``.next``, so no crash publishes parameters and
optimizer state from two training points. A file can be replaced
atomically, so the JAX package's ``.old`` step (a directory cannot) has no
counterpart here. The JSON records are written only after the checkpoint
they describe has landed. Patience is honoured: ``should_stop`` goes True
after ``patience`` epochs without improvement.
"""

from __future__ import annotations

import concurrent.futures
import fcntl
import json
import os
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.logging import Logger


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any,
                 memo: Dict[tuple, torch.Tensor]) -> Any:
    """``tree`` with every tensor replaced by ``fn(tensor)`` and every dict,
    list and tuple rebuilt. Tensors that view the same memory (a tied
    table under several keys) map to one result, so a file holds it once."""
    if isinstance(tree, torch.Tensor):
        key = (tree.device, tree.data_ptr(), tree.dtype, tuple(tree.shape),
               tree.stride())
        if key not in memo:
            memo[key] = fn(tree)
        return memo[key]
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v, memo) for v in tree)
    return tree


def tree_nbytes(tree: Any) -> int:
    """Bytes of the distinct tensors in ``tree``."""
    seen: Dict[tuple, torch.Tensor] = {}
    _map_tensors(lambda t: t, tree, seen)
    return sum(t.numel() * t.element_size() for t in seen.values())


def _snapshot(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """A copy of every tensor of ``tree``, taken on the caller's thread and
    stream, and the CUDA event recorded after the copies (None without
    device tensors). The optimizer writes parameters and moments in place,
    so a background save must own its bytes before the next step runs."""
    on_device: List[torch.device] = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            on_device.append(t.device)
        return t.detach().clone()

    snap = _map_tensors(copy, tree, {})
    event = None
    if on_device:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(on_device[0]))
    return snap, event


def _to_host(tree: Any, after: Optional[torch.cuda.Event] = None) -> Any:
    """``tree`` with its tensors on the CPU. With ``after`` (a worker saving
    a snapshot) the device->host copies run on a side stream that first
    waits for that event, so they never read a snapshot before its copy
    has finished on the caller's stream; they go into pinned host memory
    (PyTorch's caching host allocator keeps it for the next save): on an
    H100, pageable copies from a second thread made each training step
    5-10x slower while they ran."""
    if after is None:
        return _map_tensors(lambda t: t.detach().cpu(), tree, {})
    stream = torch.cuda.Stream()
    stream.wait_event(after)
    with torch.cuda.stream(stream):
        host = _map_tensors(
            lambda t: (t.detach().to("cpu", non_blocking=True) if t.is_cuda
                       else t.detach()), tree, {})
    stream.synchronize()
    return host


def checkpoint_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` on its device, floating tensors in fp32 (a
    tower held in bf16 is saved exactly, widened)."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            for k, v in model.state_dict().items()}


class CheckpointManager:
    """The ``model_checkpoints`` directory: checkpoints with crash recovery,
    background saves and JSON records.

    ``save_tree(..., background=True)`` copies the tree on the device (one
    cheap copy, safe against the next step's in-place updates) and moves the
    expensive part, the device->host copy and the file write, to one worker
    thread, so training goes on while the checkpoint lands. ``flush()``
    joins the pending saves; the trainer flushes at the end of ``train()``
    and before an exit save."""

    # in-flight background saves: each holds a device snapshot, so beyond
    # the bound queued saves of the same name are superseded (recovery only
    # needs the newest) and submission otherwise waits for the oldest
    MAX_PENDING = 2
    # and the bytes those snapshots pin on the device: the ViT family's
    # params + optimizer pair is ~3.9 GB, so a count bound alone does not
    # bound memory. Submission drains the oldest save before taking a
    # snapshot that would pass the budget: peak = budget + one snapshot.
    MAX_PENDING_BYTES = 4 * 1024 ** 3

    # saved together by ``save_pair`` and recovered together
    PAIRED = ("checkpoint-model", "state_dict_checkpoint")

    def __init__(self, output_dir: str,
                 snapshot_budget_bytes: Optional[int] = None):
        self.output_dir = os.path.join(output_dir, "model_checkpoints")
        os.makedirs(self.output_dir, exist_ok=True)
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[Any] = []    # (name, future, nbytes) triples
        self.snapshot_budget_bytes = (snapshot_budget_bytes
                                      or self.MAX_PENDING_BYTES)
        self.superseded_saves = 0
        # swap/recover against worker saves; an RLock so guards can nest
        self._swap_lock = threading.RLock()
        self._writing: set = set()       # names mid-write on the worker
        self._fs_fd: Optional[int] = None    # cross-process flock fd
        self._fs_depth = 0

    @contextmanager
    def _guard(self):
        """Thread and cross-process guard for mutations and reads of the
        directory: a flock on ``.swap.lock`` serialises processes (a server
        pointed at a live training directory); the RLock serialises threads
        and guards the depth count (two flocks on two fds of one file would
        deadlock one process, so one fd and a depth)."""
        with self._swap_lock:
            if self._fs_depth == 0:
                if self._fs_fd is None:
                    self._fs_fd = os.open(
                        os.path.join(self.output_dir, ".swap.lock"),
                        os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(self._fs_fd, fcntl.LOCK_EX)
            self._fs_depth += 1
            try:
                yield
            finally:
                self._fs_depth -= 1
                if self._fs_depth == 0:
                    fcntl.flock(self._fs_fd, fcntl.LOCK_UN)

    def _path(self, name: str) -> str:
        return os.path.join(os.path.abspath(self.output_dir), name + ".pt")

    def _recover_one_locked(self, name: str) -> None:
        """Adopt a complete ``.next`` left by a crash between its write and
        its move into place (it is the newest state). Caller holds the
        guard."""
        final = self._path(name)
        if os.path.exists(final + ".next"):
            os.replace(final + ".next", final)
            _fsync_dir(self.output_dir)

    def _recover(self, name: str) -> None:
        with self._guard():
            if name in self.PAIRED:
                self._recover_pair_locked()
            else:
                self._recover_one_locked(name)

    def _pair_lock_path(self) -> str:
        return os.path.join(self.output_dir, "pair.lock")

    def _recover_pair_locked(self) -> None:
        """Pair-aware recovery. ``_save_pair_sync`` writes both ``.next``
        files (params first, state last) before moving either, so:

          state ``.next`` present  -> the pair finished writing: adopt both
                                      (params may already be in place);
          params ``.next`` only    -> the kill came before the state landed:
                                      discard it and keep the previous pair.

        A live writer is left alone: in this process it is in ``_writing``;
        in another it holds the flock on ``pair.lock`` for its whole write
        and move (the flock dies with the process, so a killed writer never
        blocks recovery)."""
        a, b = self.PAIRED
        if self._writing & set(self.PAIRED):
            return
        fd = os.open(self._pair_lock_path(), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return                      # a live pair writer elsewhere
            a_next = self._path(a) + ".next"
            if not os.path.exists(self._path(b) + ".next") and \
                    os.path.exists(a_next):
                os.remove(a_next)
                _fsync_dir(self.output_dir)
            self._recover_one_locked(a)
            self._recover_one_locked(b)
        finally:
            os.close(fd)                    # releases the flock if held

    def _clean_strays(self, name: str) -> None:
        # half-written temporary files of killed writes are garbage
        final = self._path(name)
        for stray in (final + ".tmp", final + ".next.tmp"):
            if os.path.exists(stray):
                os.remove(stray)

    def _save_file(self, path: str, tree: Any) -> None:
        """``torch.save`` to ``path`` through a fsynced temporary file: the
        name appears only once the file is complete."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.output_dir)

    def _write_next(self, name: str, tree: Any) -> None:
        self._save_file(self._path(name) + ".next", tree)

    def _swap_locked(self, name: str) -> None:
        # a concurrent recovery (exists/restore from another thread) may
        # already have moved the complete .next into place
        final = self._path(name)
        if os.path.exists(final + ".next"):
            os.replace(final + ".next", final)
            _fsync_dir(self.output_dir)

    def _save_sync(self, name: str, tree: Any,
                   on_complete: Optional[Callable[[], None]] = None) -> None:
        self._recover(name)             # adopt/clean any earlier crash state
        self._clean_strays(name)
        with self._swap_lock:
            self._writing.add(name)
        try:
            self._write_next(name, tree)
            with self._guard():
                self._swap_locked(name)
        finally:
            with self._swap_lock:
                self._writing.discard(name)
        if on_complete is not None:
            on_complete()

    def _save_pair_sync(self, tree_a: Any, tree_b: Any,
                        on_complete: Optional[Callable[[], None]] = None
                        ) -> None:
        """Both ``.next`` files land before either move, and both moves
        happen under one hold of the guard; the ``pair.lock`` flock is held
        for the whole write and move, so another process's recovery cannot
        take the in-flight params ``.next`` for crash debris."""
        a, b = self.PAIRED
        with self._guard():
            self._recover_pair_locked()
        self._clean_strays(a)
        self._clean_strays(b)
        with self._swap_lock:
            self._writing.update(self.PAIRED)
        fd = os.open(self._pair_lock_path(), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            self._write_next(a, tree_a)   # params first,
            self._write_next(b, tree_b)   # state last (the commit record)
            with self._guard():
                self._swap_locked(a)
                self._swap_locked(b)
        finally:
            os.close(fd)
            with self._swap_lock:
                self._writing.difference_update(self.PAIRED)
        if on_complete is not None:
            on_complete()

    def _save_snapshot(self, name: str, snap: Any,
                       event: Optional[torch.cuda.Event],
                       on_complete: Optional[Callable[[], None]]) -> None:
        self._save_sync(name, _to_host(snap, event), on_complete)

    def _save_pair_snapshot(self, snap_a: Any, snap_b: Any,
                            event: Optional[torch.cuda.Event],
                            on_complete: Optional[Callable[[], None]]
                            ) -> None:
        self._save_pair_sync(_to_host(snap_a, event), _to_host(snap_b, event),
                             on_complete)

    def save_tree(self, name: str, tree: Any, background: bool = False,
                  on_complete: Optional[Callable[[], None]] = None) -> None:
        """Save ``tree`` (nested dicts, lists and tensors) as ``name``; run
        ``on_complete()`` strictly after it has landed. Metadata that points
        at the checkpoint must go through ``on_complete``."""
        if not background:
            self._save_sync(name, _to_host(tree), on_complete)
            return

        def task():
            snap, event = _snapshot(tree)
            return self._save_snapshot, name, snap, event, on_complete

        self._submit(name, tree_nbytes(tree), task)

    def save_pair(self, params: Any, state: Any, background: bool = False,
                  on_complete: Optional[Callable[[], None]] = None) -> None:
        """Save the ``checkpoint-model`` (``params``) and
        ``state_dict_checkpoint`` (``state``) pair as one atomic unit."""
        if not background:
            self._save_pair_sync(_to_host(params), _to_host(state),
                                 on_complete)
            return

        def task():
            (snap_a, snap_b), event = _snapshot((params, state))
            return (self._save_pair_snapshot, snap_a, snap_b, event,
                    on_complete)

        self._submit("+".join(self.PAIRED),
                     tree_nbytes(params) + tree_nbytes(state), task)

    def _submit(self, name: str, nbytes: int,
                make_task: Callable[[], tuple]) -> None:
        """Queue a background save of an ``nbytes`` snapshot. ``make_task()
        -> (fn, *args)`` takes the snapshot on the caller's thread, after
        the draining below, so its copy is allocated only once the budget
        has room; its bytes count until the save has landed."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="ckpt-save")
        # supersede queued, unstarted saves of the same name: the newer
        # tree is the more recent recovery state
        kept = []
        for n, f, b in self._pending:
            if n == name and f.cancel():
                self.superseded_saves += 1
            elif not f.done():
                kept.append((n, f, b))
            else:
                f.result()               # raise a worker's exception
        self._pending = kept
        while self._pending and (
                len(self._pending) >= self.MAX_PENDING
                or sum(b for _, _, b in self._pending) + nbytes
                > self.snapshot_budget_bytes):
            self._pending.pop(0)[1].result()
        fn, *args = make_task()
        self._pending.append((name, self._pool.submit(fn, *args), nbytes))

    def flush(self) -> None:
        """Join every pending background save (exceptions propagate)."""
        pending, self._pending = self._pending, []
        for _, f, _ in pending:
            f.result()

    def restore_tree(self, name: str) -> Any:
        """The saved tree, on the CPU (recovering first; the guard is held
        across the read, so another process cannot move the file away)."""
        with self._guard():
            self._recover(name)
            return torch.load(self._path(name), map_location="cpu",
                              weights_only=True)

    def exists(self, name: str) -> bool:
        with self._guard():
            self._recover(name)
            return os.path.exists(self._path(name))

    def write_json(self, name: str, obj: Any) -> None:
        # tmp + fsync + rename + dir fsync: a kill mid-write never leaves
        # truncated JSON for the resume to read
        path = os.path.join(self.output_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.output_dir)

    def read_json(self, name: str) -> Optional[Any]:
        p = os.path.join(self.output_dir, name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)


class Callbacks:
    """Base: best-model saving."""

    def __init__(self, logger: Logger, output_dir: str,
                 save_final_model: bool = False):
        self.logger = logger
        self.save_final_model = save_final_model
        self.ckpt = CheckpointManager(output_dir)
        self.best_score = 0.0
        self.mode = "max"
        self.threshold = 0.0
        # id layout of the tokenizer the weights were trained with
        self.tokenizer_scheme: Optional[str] = None
        # under a mesh the trainer sets these: the full states from a
        # rank's shards (collectives every rank joins), and whether this
        # rank writes (rank 0 alone)
        self.state_fn: Callable[[nn.Module], Dict[str, torch.Tensor]] = \
            checkpoint_state_dict
        self.optimizer_state_fn: Callable[[Any], Dict[str, Any]] = \
            lambda optimizer: optimizer.state_dict()
        self.writer = True

    def better_score(self, score: float) -> bool:
        if self.mode == "max":
            return (score - self.best_score) > self.threshold
        return (self.best_score - score) > self.threshold

    def save_checkpoint(self, model: nn.Module, epoch: int,
                        answer_spaces: List[str],
                        on_complete: Optional[Callable[[], None]] = None
                        ) -> None:
        self.logger.log_message(
            f"Saving new best-model with F-Score: {self.best_score:.4f}")
        info = {
            "epoch": epoch,
            "best_score": self.best_score,
            "answer_spaces": list(answer_spaces),
            "tokenizer_scheme": self.tokenizer_scheme,
        }

        def write_metadata() -> None:
            # on the worker, after best-model.pt has landed
            self.ckpt.write_json("model_ckpt_info.json", info)
            if on_complete is not None:
                on_complete()

        state = self.state_fn(model)
        if self.writer:
            self.ckpt.save_tree("best-model", state, background=True,
                                on_complete=write_metadata)

    def exit_training(self, model: nn.Module) -> None:
        self.ckpt.flush()              # land the in-flight background saves
        self.logger.log_block(
            f"Exiting from training early. Best model score: "
            f"{self.best_score:.4f}. Saving final model: "
            f"{self.save_final_model} ")
        if self.save_final_model:
            self.logger.log_message("Saving model ...")
            state = self.state_fn(model)
            if self.writer:
                self.ckpt.save_tree("final-model", state)
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
            self.save_checkpoint(
                model, epoch, answer_spaces,
                on_complete=lambda: self.ckpt.write_json(
                    "model-metrics.json", {"best-score": score}))
        else:
            self.num_bad_epoch += 1
            self.logger.log_new_line()
            self.logger.log_message(
                f"Bad Epoch. Total num bad epoch: {self.num_bad_epoch}")
            if self.num_bad_epoch >= self.patience:
                self.should_stop = True

    def save_epoch_checkpoint(self, model: nn.Module, epoch: int, optimizer,
                              scheduler, global_step: int = 0,
                              on_complete: Optional[Callable[[], None]] = None
                              ) -> None:
        """Submit the ``checkpoint-model`` + ``state_dict_checkpoint`` pair
        as one atomic background save. ``on_complete()`` runs on the worker
        after the pair has landed; a superseded save's never runs."""
        self.logger.log_new_line()
        self.logger.log_message("Saving Epoch Checkpoint")
        params = self.state_fn(model)
        state = {"epoch": epoch, "global_step": global_step,
                 "optimizer": self.optimizer_state_fn(optimizer),
                 "scheduler": scheduler.state_dict()}
        if self.writer:
            self.ckpt.save_pair(params, state, background=True,
                                on_complete=on_complete)
