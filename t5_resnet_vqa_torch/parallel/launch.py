"""Start the ranks of a mesh: one process per rank, one device each.

``spawn(fn, nprocs, ...)`` starts ``nprocs`` processes (multiprocessing's
"spawn" start method), each with one thread of intra-op work, its device
(``devices[rank]``; by default ``cuda:<rank>`` for NCCL and the CPU for
gloo) and the default process group, which meets through a ``FileStore``
in a fresh directory (no TCP port). Each runs ``fn(rank, *args)``; the
parent returns their results in rank order, or raises with the first
failed rank's traceback after stopping the others. Every group has a
timeout (``timeout_s``), so a collective that never completes raises
instead of hanging. An explicit ``devices`` list may repeat a card:
``chip_smoke.py`` puts several gloo ranks on one GPU, as the JAX tests put
several virtual devices on one CPU.

``launch_mesh`` is the entry points' way in. Under ``torchrun`` (its
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` environment) the process joins
the group it finds, on ``cuda:<LOCAL_RANK>`` with NCCL, and runs ``fn``
itself. Otherwise it starts data x model ranks on the first cards with
NCCL, or, when the CPU is named, on the CPU with gloo. A mesh larger than
the visible cards raises; nothing falls back to fewer ranks.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a rendezvous or a collective may take before it raises
DEFAULT_TIMEOUT_S = 120.0

_device: Optional[torch.device] = None


def current_device() -> torch.device:
    """The device the launcher gave this rank (under ``torchrun`` with
    NCCL: ``cuda:<LOCAL_RANK>``; with gloo: the CPU)."""
    if _device is not None:
        return _device
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def resolve_mesh_size(data_parallel: int, model_parallel: int,
                      device_type: str) -> int:
    """The data-axis size the flags ask for (``-1``: the visible cards over
    tp). Raises where the mesh does not fit the visible cards."""
    if model_parallel < 1:
        raise ValueError(f"--model-parallel {model_parallel} must be >= 1")
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if data_parallel == -1:
            if n % model_parallel:
                raise ValueError(f"{n} devices not divisible by model axis "
                                 f"{model_parallel}")
            data_parallel = n // model_parallel
        if data_parallel * model_parallel > n:
            raise ValueError(
                f"--data-parallel {data_parallel} x --model-parallel "
                f"{model_parallel} = {data_parallel * model_parallel} "
                f"devices, but only {n} available")
    elif data_parallel == -1:
        raise ValueError("--data-parallel -1 counts cards; on the CPU name "
                         "the data-axis size")
    if data_parallel < 1:
        raise ValueError(f"--data-parallel {data_parallel} must be >= 1")
    return data_parallel


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(rank: int, world_size: int, backend: str,
                       store_path: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """The default group: through a ``FileStore`` at ``store_path``, or
    ``env://`` (torchrun's variables) without one."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size, timeout=timeout)


def _worker(rank: int, fn: Callable, args: Sequence[Any], devices: List[str],
            backend: str, store_path: str, timeout_s: float, results) -> None:
    global _device
    torch.set_num_threads(1)
    _device = torch.device(devices[rank])
    if _device.type == "cuda":
        torch.cuda.set_device(_device)
    try:
        init_process_group(rank, len(devices), backend, store_path,
                           timeout_s)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (),
          devices: Optional[Sequence[str]] = None,
          backend: Optional[str] = None, store_dir: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks (see the module
    docstring); ``fn`` must be importable by name (a module-level function
    of a module the children can import). Returns the results by rank."""
    import multiprocessing as mp
    import queue

    if devices is None:
        devices = ([f"cuda:{i}" for i in range(nprocs)] if backend == "nccl"
                   else ["cpu"] * nprocs)
    devices = [str(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    if backend is None:
        backend = "gloo"
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="mesh_store_") if own_dir \
        else store_dir
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        r, fn, tuple(args), devices, backend, store_path, timeout_s, results))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * nprocs
    failure = None
    try:
        pending = nprocs
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead and failure is None:
                    # a rank died without reporting (killed, or a crash in
                    # the interpreter): give the queue a moment, then stop
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = (dead[0], f"rank {dead[0]} exited with "
                                   f"code {procs[dead[0]].exitcode}")
                        break
                else:
                    continue
            pending -= 1
            if ok:
                out[rank] = value
            else:
                failure = (rank, value)
                break
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"mesh rank {failure[0]} failed:\n{failure[1]}")
    return out


def launch_mesh(fn: Callable, args: Sequence[Any], data_parallel: int,
                model_parallel: int, device_type: str) -> None:
    """Run ``fn(rank, *args)`` on every rank of a data x model mesh (see
    the module docstring); ``data_parallel`` is already resolved."""
    global _device
    n = data_parallel * model_parallel
    if under_torchrun():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if device_type == "cuda":
            _device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(_device)
        else:
            _device = torch.device("cpu")
        init_process_group(int(os.environ["RANK"]),
                           int(os.environ["WORLD_SIZE"]), backend)
        try:
            fn(dist.get_rank(), *args)
        finally:
            dist.destroy_process_group()
        return
    if device_type == "cuda":
        spawn(fn, n, args, backend="nccl")
    else:
        spawn(fn, n, args, backend="gloo")
