"""Per-stage timing aggregation, the throughput counter and a profiler
trace context (port of ``lili_om_tpu/utils/metrics.py``: ``StageMetrics``,
and ``device_trace`` over ``torch.profiler`` where JAX's wraps
``jax.profiler``).

PyTorch returns before the card finishes, so a host clock around a stage
measures its enqueue. ``sync``, when given (``torch.cuda.synchronize`` on
the card), is called at the end of every stage before the clock is read, so
each sample is the stage's own time on the card.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch


class StageMetrics:
    """Per-stage wall-time registry + throughput counter."""

    def __init__(self, sync: Callable[[], None] | None = None):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self._t_first: float | None = None
        self._n_scans = 0
        self._sync = sync

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                self._sync()
            self.samples[name].append(time.perf_counter() - t0)

    def count_scan(self):
        if self._t_first is None:
            self._t_first = time.perf_counter()
        self._n_scans += 1

    @property
    def scans_per_sec(self) -> float:
        if self._t_first is None or self._n_scans < 2:
            return 0.0
        return (self._n_scans - 1) / max(time.perf_counter() - self._t_first, 1e-9)

    def report(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(a),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "total_s": float(a.sum()),
            }
        if self._n_scans:
            out["_throughput"] = {"scans": self._n_scans,
                                  "scans_per_sec": self.scans_per_sec}
        return out

    def pretty(self) -> str:
        lines = []
        for name, st in sorted(self.report().items()):
            if name == "_throughput":
                lines.append(f"throughput: {st['scans_per_sec']:.1f} scans/s "
                             f"({st['scans']} scans)")
            else:
                lines.append(f"{name:24s} n={st['n']:<5d} mean={st['mean_ms']:7.2f} ms "
                             f"p50={st['p50_ms']:7.2f} p95={st['p95_ms']:7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace context: the window's host operations and,
    whenever a card is present, its kernels and copies, written as a Chrome
    trace (``chrome://tracing``, Perfetto) to
    ``logdir/trace_<pid>_<ns>.json``; the path is the yielded profiler's
    ``trace_path`` once the window closes. The window ends with a
    synchronize, so every kernel it launched is in the trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
