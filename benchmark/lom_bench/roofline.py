"""The kNN searches' roofline share: the work counted at the public search
calls from their arguments, against the device time of the kernels those
calls launched.

``KnnSpy`` wraps ``knn_auto`` (wherever the program's modules bind it:
``world_knn_auto`` and ``knn_pair_auto`` reach it through ``ops/knn.py``)
and ``searcher`` (ICP's prepared target: the preparation is a span with no
work of its own, each search a span with its work). Each call is a
profiler span (``bench.knn``, ``bench.knn_prep``) and a record of its
shapes and masks; the masks are counted after the traced slice, so the spy
adds no device work. Installed only for the traced slice.

Work of one search of Q queries (q valid) among P points (p valid) for k
neighbours, float32: 8 operations a valid pair (three differences, three
squares, two sums); bytes: queries and points read once (12 bytes a row),
each mask once (a byte a row), the (Q,k) distances (4 bytes) and indices
(8 bytes) written once. The bound is the larger of the operations at the
float32 peak and the bytes at the memory bandwidth.
"""
from __future__ import annotations

import sys
import threading
from typing import NamedTuple

import torch

# NVIDIA H100 SXM, published: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
OPS_PER_PAIR = 8
IDX_BYTES = 8


class KnnCall(NamedTuple):
    n_q: int  # queries (rows)
    n_p: int  # points (rows)
    k: int
    q_mask: torch.Tensor | None
    p_mask: torch.Tensor | None
    elem_bytes: int


def work(n_q: int, n_p: int, k: int, q_valid: int, p_valid: int, q_masked: bool,
         p_masked: bool, elem_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one search."""
    ops = float(OPS_PER_PAIR) * q_valid * p_valid
    nbytes = (3 * elem_bytes * (n_q + n_p) + (n_q if q_masked else 0) + (n_p if p_masked else 0)
              + n_q * k * (elem_bytes + IDX_BYTES))
    return ops, float(nbytes)


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)


def _valid(mask, n: int) -> int:
    return n if mask is None else int(mask.sum())


class KnnSpy:
    """Spans and records of every kNN search while installed."""

    def __init__(self):
        self.calls: list = []  # KnnCall per ``bench.knn`` span, in order
        self._depth = threading.local()
        self._patched: list = []

    def _record(self, queries, n_p, k, q_mask, p_mask):
        self.calls.append(KnnCall(queries.shape[0], n_p, k, q_mask, p_mask,
                                  queries.element_size()))

    def _outer(self) -> bool:
        return getattr(self._depth, "n", 0) == 0

    def _enter(self):
        self._depth.n = getattr(self._depth, "n", 0) + 1

    def _exit(self):
        self._depth.n -= 1

    def install(self, knn_module, icp_module):
        orig_auto, orig_searcher = knn_module.knn_auto, knn_module.searcher
        spy = self

        def knn_auto(queries, points, k=5, p_mask=None, q_mask=None):
            if not spy._outer():
                return orig_auto(queries, points, k, p_mask, q_mask)
            spy._enter()
            try:
                spy._record(queries, points.shape[0], k, q_mask, p_mask)
                with torch.profiler.record_function("bench.knn"):
                    return orig_auto(queries, points, k, p_mask, q_mask)
            finally:
                spy._exit()

        def searcher(points, p_mask, queries, q_mask):
            spy._enter()
            try:
                with torch.profiler.record_function("bench.knn_prep"):
                    search = orig_searcher(points, p_mask, queries, q_mask)
            finally:
                spy._exit()

            def traced(pw, k):
                spy._enter()
                try:
                    spy._record(pw, points.shape[0], k, q_mask, p_mask)
                    with torch.profiler.record_function("bench.knn"):
                        return search(pw, k)
                finally:
                    spy._exit()
            return traced

        # every module of the program that bound the originals
        for mod in list(sys.modules.values()):
            name = getattr(mod, "__name__", "")
            if not name.startswith(knn_module.__name__.split(".")[0] + "."):
                continue
            for attr, orig, new in (("knn_auto", orig_auto, knn_auto),
                                    ("searcher", orig_searcher, searcher)):
                if getattr(mod, attr, None) is orig:
                    setattr(mod, attr, new)
                    self._patched.append((mod, attr, orig))
        return self

    def uninstall(self):
        for mod, attr, orig in self._patched:
            setattr(mod, attr, orig)
        self._patched.clear()

    def work(self) -> list:
        """(operations, bytes) of each recorded search, in order."""
        return [work(c.n_q, c.n_p, c.k, _valid(c.q_mask, c.n_q), _valid(c.p_mask, c.n_p),
                     c.q_mask is not None, c.p_mask is not None, c.elem_bytes)
                for c in self.calls]
