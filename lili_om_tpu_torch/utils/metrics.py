"""The port's one tracer: per-stage timing, counters and host reads, the
throughput counter and a profiler trace context (port of
``lili_om_tpu/utils/metrics.py``: ``StageMetrics``, and ``device_trace``
over ``torch.profiler`` where JAX's wraps ``jax.profiler``).

PyTorch returns before the card finishes, so a host clock around a stage
measures its enqueue. ``sync``, when given (``torch.cuda.synchronize`` on
the card), is called at the end of every stage before the clock is read, so
each sample is the stage's own time on the card.

Every series lives in :attr:`StageMetrics.samples`, one list a name:

* a stage (:meth:`StageMetrics.stage`): seconds, ending in ``sync``;
* a span (:func:`span`): seconds on the host clock inside a stage, with no
  synchronize (the enqueue and whatever host reads it makes);
* a counter (:func:`count`): the counts added inside one stage, summed and
  recorded as one sample when the stage ends; :attr:`StageMetrics.kinds`
  marks it ``"count"``;
* a host read (:func:`host_read`): ``host_read.<site>``, the seconds the host
  was blocked reading the device (wait plus copy), one sample a read.

A stage or an entry (:meth:`StageMetrics.entry`) makes its instance the
thread's current one for its duration, and the module-level :func:`span`,
:func:`count` and :func:`host_read` act on that instance, so the free
functions of ``models/`` reach the system's metrics without an argument;
called with none current (a test, ``parallel/dist_fusion.py`` driving
``fusion_step`` directly) they do nothing. Each thread has its own current
instance.

While ``torch.profiler`` records, every stage and span opens
``record_function("lom.<name>")`` on the profiler's timeline, and an entry
``lom.scan`` / ``lom.closure`` with a zero-work child ``lom.id/<ordinal>``
(the Chrome export drops ``record_function``'s arguments). With no profiler
running none is entered.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

# (the thread's current StageMetrics, the innermost stage's or entry's counts)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("lom_metrics", default=None)


def _annotate(name: str):
    """``record_function("lom.<name>")`` while the profiler records, else
    nothing (entering one costs ~11 µs even with no profiler)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("lom." + name)
    return contextlib.nullcontext()


class StageMetrics:
    """Per-stage wall-time registry, counters, host reads and a throughput
    counter."""

    def __init__(self, sync: Callable[[], None] | None = None):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.kinds: Dict[str, str] = {}  # series -> "count"; absent: seconds
        self._t_first: float | None = None
        self._n_scans = 0
        self._sync = sync

    @contextlib.contextmanager
    def current(self) -> Iterator[None]:
        """This instance current on the thread, with a fresh set of counts
        recorded when the block ends (a stage's, an entry's, or a block's
        that is neither and whose host reads are to be recorded)."""
        counts: Dict[str, int] = {}
        token = _CURRENT.set((self, counts))
        try:
            yield
        finally:
            _CURRENT.reset(token)
            for name, n in counts.items():
                self.kinds[name] = "count"
                self.samples[name].append(n)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with self.current(), _annotate(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self._sync is not None:
                    self._sync()
                self.samples[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def entry(self, name: str, ordinal) -> Iterator[None]:
        """A call into the system (``scan``, ``closure``): this instance
        current, and while the profiler records ``lom.<name>`` holding
        ``lom.id/<ordinal>``. ``ordinal``: an int, or a function giving it
        (called only while the profiler records). Records no sample."""
        with self.current():
            if not torch.autograd._profiler_enabled():
                yield
                return
            with torch.profiler.record_function("lom." + name):
                n = ordinal() if callable(ordinal) else ordinal
                with torch.profiler.record_function(f"lom.id/{n}"):
                    pass
                yield

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
        """Per series: n, mean, p50, p95 and total, in ms for a time (and
        its total in s), as counted for a counter."""
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs, dtype=np.float64)
            if self.kinds.get(name) == "count":
                out[name] = {"n": len(a), "mean": float(a.mean()),
                             "p50": float(np.percentile(a, 50)),
                             "p95": float(np.percentile(a, 95)), "total": float(a.sum())}
                continue
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
            elif "mean" in st:
                lines.append(f"{name:24s} n={st['n']:<5d} mean={st['mean']:7.2f}    "
                             f"p50={st['p50']:7.2f} p95={st['p95']:7.2f} (count)")
            else:
                lines.append(f"{name:24s} n={st['n']:<5d} mean={st['mean_ms']:7.2f} ms "
                             f"p50={st['p50_ms']:7.2f} p95={st['p95_ms']:7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A part of a stage on the host clock, no synchronize: its seconds go
    to the current instance's ``samples[name]``. Also a decorator."""
    cur = _CURRENT.get()
    if cur is None:
        yield
        return
    with _annotate(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            cur[0].samples[name].append(time.perf_counter() - t0)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the innermost stage (or entry) under
    way; the stage records the sum as one sample when it ends."""
    cur = _CURRENT.get()
    if cur is not None:
        cur[1][name] = cur[1].get(name, 0) + n


@contextlib.contextmanager
def host_read(site: str) -> Iterator[None]:
    """One explicit device→host read: the seconds the host is blocked in
    the block go to the current instance's ``samples["host_read.<site>"]``."""
    cur = _CURRENT.get()
    if cur is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        cur[0].samples["host_read." + site].append(time.perf_counter() - t0)


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
