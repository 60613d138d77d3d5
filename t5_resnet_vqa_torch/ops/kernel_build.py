"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` inside the package, at first use. The hash
covers the source, every shared header ``csrc/*.cuh`` and the compiler
flags, so an edited source or header builds anew and an unchanged one is
reused. ``function`` returns a library's entry point with its ctypes
signature set once, at load time. ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for them together; asked for it, it returns
each build's ``ptxas -v`` report (registers, spills per kernel), which
leaves the library as it is and so is not in the hash.

Nothing here runs at import time: the CPU tests import every module, and a
machine without ``nvcc`` never reaches this code (the kernel wrappers use
their plain PyTorch versions for CPU tensors).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in t5_resnet_vqa_torch/csrc")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str], ptxas_info: bool = False) -> Dict[str, str]:
    """Compile every named source whose library is missing, in parallel.
    Returns the compiler's output by name for the libraries it built
    (``ptxas_info``: with ``-Xptxas -v``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
               "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed, logs = [], {}
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu``'s library, returning a C int (a CUDA
    error code), with ``argtypes`` set on its first use only."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
