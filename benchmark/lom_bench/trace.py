"""The traced slice: ``torch.profiler`` over a fixed stretch of a session,
its Chrome trace written under ``TMPDIR`` and read back, then deleted.

From the trace: the device operations (kernels, copies, sets) and their
union (busy time), the kernel launches, the idle gaps with what the host
was doing at each gap's start (the innermost ``bench.*`` span and the
innermost host operation), and the device time of the kernels launched
inside each ``bench.knn*`` span (by the launch's correlation id)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

import torch

from .stats import idle_gaps, merged_busy

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


class TraceData(NamedTuple):
    window_s: float  # first to last bench span of the slice
    busy_s: float  # union of device operations in the window
    n_kernels: int
    device_ops: list  # [[name, seconds]] the ten longest in total
    idle_gaps: list  # [[host context, seconds]] the ten longest
    knn_times: list  # device seconds of the kernels of each bench.knn span, in order
    knn_prep_s: float  # device seconds of the kernels of bench.knn_prep spans


def profile(fn) -> str:
    """Run ``fn`` under the profiler (host and device); returns the path of
    its Chrome trace, in the temporary directory."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(tempfile.gettempdir(), f"lom_bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def _innermost(spans, starts, t):
    """The innermost (latest-starting) span of ``spans`` (sorted by start)
    that contains time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    # spans nest, so walk back until one ends before t and no enclosing one is left
    for j in range(i, max(i - 4096, -1), -1):
        s, e, name = spans[j]
        if s <= t < e:
            best = name
            break
    return best


def read(path: str) -> TraceData:
    """The trace at ``path`` (deleted once read)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev, launches, bench, ops = [], {}, defaultdict(list), []
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, ev["name"], cat, ev.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, ev.get("tid"))
        elif cat == "user_annotation" and ev["name"].startswith("bench."):
            bench[ev.get("tid")].append((ts, ts + dur, ev["name"]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, ev["name"]))
    spans = sorted(s for v in bench.values() for s in v)
    if not spans:
        raise RuntimeError("the trace holds no bench span")
    lo, hi = spans[0][0], max(e for _, e, _ in spans)
    window_us = hi - lo
    intervals = [(max(s, lo), min(e, hi)) for s, e, *_ in dev if e > lo and s < hi]
    busy_us = merged_busy(intervals)

    per_name = defaultdict(float)
    for s, e, name, *_ in dev:
        per_name[name] += e - s
    device_ops = [[n, t * 1e-6] for n, t in sorted(per_name.items(), key=lambda x: -x[1])[:10]]

    ops.sort()
    op_starts = [s for s, _, _ in ops]
    span_starts = [s for s, _, _ in spans]
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for s, e in gaps:
        where = _innermost(spans, span_starts, s) or "outside"
        what = _innermost(ops, op_starts, s) or "python"
        labelled.append([f"{where}/{what}", (e - s) * 1e-6])

    # kernels launched inside each knn span (on the span's thread)
    knn_spans = {tid: sorted(x for x in v if x[2] in ("bench.knn", "bench.knn_prep"))
                 for tid, v in bench.items()}
    knn_starts = {tid: [s for s, _, _ in v] for tid, v in knn_spans.items()}
    order = {tid: {(s, e): i for i, (s, e, n) in enumerate(v)} for tid, v in knn_spans.items()}
    per_span = defaultdict(float)
    for s, e, name, cat, corr in dev:
        if cat != "kernel" or corr not in launches:
            continue
        t_launch, tid = launches[corr]
        v = knn_spans.get(tid)
        if not v:
            continue
        i = bisect.bisect_right(knn_starts[tid], t_launch) - 1
        # innermost knn span holding the launch
        while i >= 0 and not (v[i][0] <= t_launch < v[i][1]):
            i -= 1
        if i >= 0:
            per_span[(tid, i)] += e - s
    knn_times, prep = [], 0.0
    all_knn = sorted((s, e, n, tid, order[tid][(s, e)]) for tid, v in knn_spans.items()
                     for s, e, n in v)
    for s, e, n, tid, i in all_knn:
        t = per_span.get((tid, i), 0.0) * 1e-6
        if n == "bench.knn":
            knn_times.append(t)
        else:
            prep += t
    n_kernels = sum(1 for x in dev if x[3] == "kernel")
    return TraceData(window_us * 1e-6, busy_us * 1e-6, n_kernels, device_ops, labelled,
                     knn_times, prep)
