"""Build and load the port's CUDA kernels and its host runtime library.

Each source under ``csrc/`` is compiled into a shared library with a plain
C interface, at first use, into ``lili_om_tpu_torch/_build/`` (listed in
``.gitignore``): a ``.cu`` kernel by ``nvcc`` for ``sm_90a``, the host
runtime ``lili_runtime.cc`` (:mod:`.runtime.native`) by the host C++
compiler (``$CXX``, else ``g++``) with ``native/Makefile``'s flags. The file
name carries a hash of the source, of the kernels' shared headers
(``csrc/*.cuh``) and of the flags, so an edited source is rebuilt and an
unchanged one is reused. Libraries are loaded with ``ctypes``. A failed
build raises with the compiler's output: nothing falls back.

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
SOURCES = {"knn": "knn.cu", "knn_pruned": "knn_pruned.cu", "segred": "segred.cu",
           "blocktri": "blocktri.cu", "lili_runtime": "lili_runtime.cc"}
# the sources built by the host compiler, not by nvcc
HOST_SOURCES = {"lili_runtime"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared"]

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


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"the host C++ compiler {cxx!r} was not found: set CXX or put "
                           "g++ on PATH")
    return path


def library_path(name: str) -> Path:
    """The library of source ``name``; its tag hashes the source, the flags
    and, for a kernel, every shared header of ``csrc/``."""
    src = (CSRC / SOURCES[name]).read_bytes()
    if name in HOST_SOURCES:
        flags = CXX_FLAGS
    else:
        src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        flags = NVCC_FLAGS
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _command(name: str, out: Path, verbose: bool) -> list:
    src = str(CSRC / SOURCES[name])
    if name in HOST_SOURCES:
        return [cxx_path(), *CXX_FLAGS, "-o", str(out), src]
    return [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
            "-o", str(out), src]


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    compiler per source, all started together. ``verbose`` adds
    ``-Xptxas -v`` to the kernels' (registers, shared memory and spills per
    kernel). Returns ``{name: compiler output}`` for the sources it
    compiled; raises with the compiler's output if any build fails. Holds
    the module lock throughout (threads), and names its temporary outputs
    by process and thread, moved into place with ``os.replace`` (processes
    that build the same source at once each write their own file, and the
    last rename wins with the same bytes)."""
    with _LOCK:
        names = list(SOURCES) if names is None else list(names)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
            proc = subprocess.Popen(_command(name, tmp, verbose), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("the build failed for " + "\n".join(failed))
        return logs


def stream_ptr(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on the CUDA ``device`` (a
    tensor's, so its index is set), for a launch. The call that PyTorch's
    own generated kernels use: it skips building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed; built
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
