"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``lili_om_tpu_torch/_build/`` (listed in ``.gitignore``). The file name
carries a hash of the source and of the shared headers (``csrc/*.cuh``), so
an edited kernel is rebuilt and an unchanged one is reused. Libraries are loaded with ``ctypes``.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"knn": "knn.cu", "knn_pruned": "knn_pruned.cu", "segred": "segred.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}
# one build and one load at a time: the runtime's worker threads may reach
# the same kernel first together
_LOCK = threading.RLock()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library of kernel ``name``; its tag hashes the source, every
    shared header of ``csrc/`` and the flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel).
    Returns ``{name: compiler output}`` for the sources it compiled; raises
    with the compiler's output if any build fails. Holds the module lock
    throughout, and names its temporary outputs by process and thread."""
    with _LOCK:
        names = list(SOURCES) if names is None else list(names)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def stream_ptr(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on the CUDA ``device`` (a
    tensor's, so its index is set), for a launch. The call that PyTorch's
    own generated kernels use: it skips building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed; built
    and loaded once however many threads ask at the same time."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
