"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` inside the package, at first use. The hash
covers the source, every shared header ``csrc/*.cuh`` and the compiler
flags, so an edited source or header builds anew and an unchanged one is
reused. ``function`` returns a library's entry point with its ctypes
signature set once, at load time. ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for them together; asked for it, it returns
each build's ``ptxas -v`` report (registers, spills per kernel), which
leaves the library as it is and so is not in the hash. ``build_variants``
builds altered copies of one source side by side, for timing a kernel's
design alternatives against it (the ``ablate_*.py`` scripts).

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
from typing import Dict, Mapping, Sequence, Tuple

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


def _nvcc_all(jobs: Sequence[Tuple[str, str, str]], ptxas_info: bool
              ) -> Dict[str, str]:
    """One ``nvcc`` per ``(key, source, library)``, all at once; raises if
    any fails. Returns the compiler's output by key."""
    procs = [(key, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
         "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for key, src, lib in jobs]
    failed, logs = [], {}
    for key, proc in procs:
        logs[key] = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{key}:\n{logs[key]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build(names: Sequence[str], ptxas_info: bool = False) -> Dict[str, str]:
    """Compile every named source whose library is missing, in parallel.
    Returns the compiler's output by name for the libraries it built
    (``ptxas_info``: with ``-Xptxas -v``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = [(name, os.path.join(CSRC_DIR, f"{name}.cu"),
             f"{library_path(name)}.{os.getpid()}.tmp")
            for name in names if not os.path.exists(library_path(name))]
    logs = _nvcc_all(jobs, ptxas_info)
    for name, _, tmp in jobs:
        os.replace(tmp, library_path(name))   # atomic: never half a file
    return logs


def build_variants(name: str,
                   variants: Mapping[str, Tuple[str, Sequence[Tuple[str, str,
                                                                    str]]]],
                   out_dir: str) -> Dict[str, Tuple[str, str]]:
    """Build ``<name>.cu`` once per variant, all at once with ``-Xptxas
    -v``. ``variants`` maps a variant to the source directory it copies
    (``<name>.cu`` and every ``*.cuh``) and the text substitutions
    ``(file, old, new)`` made in the copy, each of which must match exactly
    once. Sources and library go to ``out_dir/<variant>/``. Returns
    {variant: (library, compiler output)}."""
    jobs = []
    for variant, (csrc, subs) in variants.items():
        files = {}
        for fname in os.listdir(csrc):
            if fname == f"{name}.cu" or fname.endswith(".cuh"):
                with open(os.path.join(csrc, fname)) as f:
                    files[fname] = f.read()
        for fname, old, new in subs:
            n = files[fname].count(old)
            if n != 1:
                raise ValueError(f"{variant}: {old[:60]!r} matches {n} times "
                                 f"in {fname}")
            files[fname] = files[fname].replace(old, new)
        d = os.path.join(out_dir, variant)
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        jobs.append((variant, os.path.join(d, f"{name}.cu"),
                     os.path.join(d, f"{name}.so")))
    logs = _nvcc_all(jobs, ptxas_info=True)
    return {variant: (lib, logs[variant]) for variant, _, lib in jobs}


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
