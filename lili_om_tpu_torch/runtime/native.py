"""ctypes bindings of the port's native host runtime (``csrc/lili_runtime.cc``,
the port's copy of ``native/lili_runtime.cc``): the counterpart of
``lili_om_tpu/runtime/native.py``, with the same names.

* :class:`Ring`: a lock-free SPSC ring of fixed-size records (the runner's
  IMU ring);
* :class:`Sequencer`: the multi-stream stamp aligner (the runner's gate);
* :func:`pcd_write_native`: the binary PCD writer (``export_map``);
* :class:`LogWriter` / :class:`LogReader`: the ``.lom`` record log, read
  ahead by a C++ thread (``io/dataset.py``).

The library is built at first use (not at import) by
:func:`..cuda_build.build` with the host C++ compiler into
``lili_om_tpu_torch/_build/``, under a name that carries a hash of the
source. Unlike the JAX module, which reports ``available() == False`` when
its ``make`` fails and lets its callers fall back to pure Python, a failed
build raises ``RuntimeError`` with the compiler's output: no path of the
port falls back. :func:`available` says whether the library is built and
loaded; nothing consults it to choose a path.

``ctypes`` releases the interpreter lock for the length of each call, so
the ring, the sequencer and the reader's thread run outside it. The plain
versions stay for the tests: ``runtime/pipeline.py:_PySequencer``,
``runtime/log.py`` and ``io/pcd.py:write_pcd`` give the same results and
the same bytes.
"""
from __future__ import annotations

import atexit
import ctypes
import threading
import time
import weakref
from typing import Optional

import numpy as np

from .. import cuda_build

_NAME = "lili_runtime"
_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, size = ctypes.c_void_p, ctypes.c_size_t
    sigs = {
        "ring_create": (ptr, [size, size]),
        "ring_destroy": (None, [ptr]),
        "ring_push": (ctypes.c_int, [ptr, ptr]),
        "ring_pop": (ctypes.c_int, [ptr, ptr]),
        "ring_size": (size, [ptr]),
        "seq_create": (ptr, [ctypes.c_int, ctypes.c_double]),
        "seq_destroy": (None, [ptr]),
        "seq_push": (None, [ptr, ctypes.c_int, ctypes.c_double, ctypes.c_uint64]),
        "seq_try_pop": (ctypes.c_int, [ptr, ctypes.POINTER(ctypes.c_double),
                                       ctypes.POINTER(ctypes.c_uint64)]),
        "pcd_write": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_uint64, ctypes.c_int]),
        "log_writer_open": (ptr, [ctypes.c_char_p]),
        "log_writer_append": (ctypes.c_int, [ptr, ctypes.c_uint32, ptr, ctypes.c_uint32]),
        "log_writer_close": (None, [ptr]),
        "log_reader_open": (ptr, [ctypes.c_char_p, size]),
        "log_reader_peek": (ctypes.c_int64, [ptr, ctypes.POINTER(ctypes.c_uint32)]),
        "log_reader_pop": (ctypes.c_int, [ptr, ptr]),
        "log_reader_close": (None, [ptr]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises with the
    compiler's output when the build fails)."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = _bind(cuda_build.load(_NAME))
        return _lib


def library_path():
    """Where the library of the current source is (or will be) built."""
    return cuda_build.library_path(_NAME)


def available() -> bool:
    """Whether the library is built and loaded (in this process)."""
    return _lib is not None


class Ring:
    """Lock-free SPSC ring of fixed-size records (bounded topic queue): one
    producer thread pushes, one consumer thread pops."""

    def __init__(self, record_size: int, capacity: int):
        self._lib = library()
        self._h = self._lib.ring_create(record_size, capacity)
        self.record_size, self.capacity = record_size, capacity

    def push(self, rec: np.ndarray) -> bool:
        """Copies ``rec`` (``record_size`` bytes) in; False when full."""
        rec = np.ascontiguousarray(rec)
        if rec.nbytes != self.record_size:
            raise ValueError(f"a record is {self.record_size} bytes, got {rec.nbytes}")
        return self._lib.ring_push(self._h, rec.ctypes.data) == 0

    def pop(self) -> Optional[np.ndarray]:
        """The oldest record as uint8 bytes, or None when empty."""
        out = np.empty(self.record_size, np.uint8)
        if self._lib.ring_pop(self._h, out.ctypes.data) != 0:
            return None
        return out

    def __len__(self):
        return int(self._lib.ring_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None


class Sequencer:
    """Multi-stream stamp aligner (the backend's input gate): ``try_pop``
    returns one bundle ``(stamps, handles)`` once every stream has an entry
    within ``tol`` of the slowest stream's front, dropping entries too old
    to match; None otherwise."""

    def __init__(self, n_streams: int, tol: float = 0.1):
        self._lib = library()
        self._h = self._lib.seq_create(n_streams, tol)
        self.n = n_streams
        self._stamps = (ctypes.c_double * n_streams)()
        self._handles = (ctypes.c_uint64 * n_streams)()

    def push(self, stream: int, stamp: float, handle: int):
        self._lib.seq_push(self._h, stream, stamp, handle)

    def try_pop(self):
        if self._lib.seq_try_pop(self._h, self._stamps, self._handles) != 1:
            return None
        return list(self._stamps), list(self._handles)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.seq_destroy(self._h)
            self._h = None


def pcd_write_native(path: str, pts: np.ndarray, intensity: np.ndarray | None = None) -> bool:
    """Binary PCD v0.7 of ``pts`` (N,3) (+ ``intensity``), float32, the bytes
    of ``io/pcd.py:write_pcd``. True on success, False when the file could
    not be written."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    if intensity is not None:
        data = np.concatenate([pts, np.asarray(intensity, np.float32)[:, None]], axis=1)
    else:
        data = pts
    data = np.ascontiguousarray(data, np.float32)
    return library().pcd_write(path.encode(),
                               data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               data.shape[0], data.shape[1]) == 0


# record kinds of the dataset log
KIND_SCAN = 1
KIND_IMU = 2
KIND_META = 3


class LogWriter:
    """Dataset record-log writer (the rosbag replacement): each record is
    ``u32 kind``, ``u32 nbytes``, the payload."""

    def __init__(self, path: str):
        self._lib = library()
        self._h = self._lib.log_writer_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def append(self, kind: int, payload: np.ndarray):
        payload = np.ascontiguousarray(payload)
        if self._lib.log_writer_append(self._h, kind, payload.ctypes.data, payload.nbytes):
            raise OSError("log append failed")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.log_writer_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# readers still open, closed at interpreter exit: each owns a C++ thread
_OPEN_READERS: "weakref.WeakSet[LogReader]" = weakref.WeakSet()


@atexit.register
def _close_readers():
    for r in list(_OPEN_READERS):
        r.close()


class LogReader:
    """Dataset record-log reader: a C++ thread reads up to ``readahead``
    records ahead into a bounded queue; iterating yields ``(kind, payload
    as uint8 array)`` in file order. A truncated last record ends the log.
    While the queue is empty the consumer sleeps 0.5 ms between polls (the
    interpreter lock is free meanwhile). ``close`` (also on collection and
    at interpreter exit) stops and joins the thread, mid-file too."""

    POLL_S = 0.0005

    def __init__(self, path: str, readahead: int = 64):
        self._lib = library()
        self._h = self._lib.log_reader_open(path.encode(), readahead)
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._kind = ctypes.c_uint32()
        _OPEN_READERS.add(self)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise StopIteration
        while True:
            n = self._lib.log_reader_peek(self._h, ctypes.byref(self._kind))
            if n == -1:
                raise StopIteration
            if n == -2:
                time.sleep(self.POLL_S)
                continue
            out = np.empty(int(n), np.uint8)
            if self._lib.log_reader_pop(self._h, out.ctypes.data) != 0:
                continue
            return int(self._kind.value), out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.log_reader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
