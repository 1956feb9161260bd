"""The dataset record log (``.lom``) in pure Python: the plain version of
the native log (``runtime/native.py``'s ``LogWriter`` / ``LogReader`` over
``csrc/lili_runtime.cc``, the port's copy of ``native/lili_runtime.cc``),
which ``io/dataset.py`` uses; the tests hold the two together.

A log is a sequence of records, each ``u32 kind``, ``u32 nbytes``, then
``nbytes`` of payload, little-endian, with no file header: the native
writer's bytes, so a log written by either package reads in the other.
:class:`LogReader` parses on a readahead thread into a bounded queue, so
record parsing overlaps the consumer's work, as the native reader does.
"""
from __future__ import annotations

import queue
import struct
import threading

import numpy as np

# record kinds of the dataset log
KIND_SCAN = 1
KIND_IMU = 2
KIND_META = 3

_HEAD = struct.Struct("<II")


class LogWriter:
    """Appends records to a new log at ``path``."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def append(self, kind: int, payload: np.ndarray):
        data = np.ascontiguousarray(payload).tobytes()
        self._f.write(_HEAD.pack(kind, len(data)))
        self._f.write(data)

    def close(self):
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __del__(self):
        self.close()


class LogReader:
    """Iterates ``(kind, payload as uint8 array)`` in file order, read ahead
    by a thread into a queue of at most ``readahead`` records. A truncated
    last record ends the log, as in the native reader."""

    _END = object()

    def __init__(self, path: str, readahead: int = 64):
        self._f = open(path, "rb")
        self._q: queue.Queue = queue.Queue(maxsize=max(readahead, 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._done = False
        self._th = threading.Thread(target=self._read, daemon=True)
        self._th.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _read(self):
        try:
            while not self._stop.is_set():
                head = self._f.read(_HEAD.size)
                if len(head) < _HEAD.size:
                    break
                kind, n = _HEAD.unpack(head)
                data = np.empty(n, np.uint8)
                if self._f.readinto(memoryview(data)) < n:
                    break
                if not self._put((kind, data)):
                    return
        except BaseException as e:  # handed to the consumer
            self._err = e
        self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        if getattr(self, "_f", None) is not None:
            self._done = True
            self._stop.set()
            self._th.join()
            self._f.close()
            self._f = None

    def __del__(self):
        self.close()
