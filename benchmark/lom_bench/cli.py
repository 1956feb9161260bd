"""One run of one cell: set-up (kernels, the log from the seed, a warm
session), the timed window, the check against the reference, and with
``--trace 1`` the traced slice; then one JSON line."""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import NamedTuple

import torch

from . import capture as capture_mod
from . import check, isolation, logs, program, stats, trace, window
from .registry import Registry

DEVICE = "cuda"


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""

    stages: dict  # stage -> the window's samples (s)
    trace: trace.TraceData | None
    trace_scans: int
    knn_work: list  # (operations, bytes) of each traced kNN search


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell of lili_om_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def warm(cfg, traffic, log, device):
    """One short session: every stage, kernel and path the window takes
    (in revisit traffic past the first closure with a candidate)."""
    sys_ = window.new_session(cfg, traffic, log, device)
    window.replay(sys_, cfg, traffic, log, 0, traffic["warm_scans"], device)
    del sys_
    window._sync(device)


def traced_slice(cfg, traffic, log, device):
    """A fresh session to ``trace_scans[1]``, profiled over
    ``trace_scans``, with the kNN spy on. Returns (TraceData, scans, work)."""
    import lili_om_tpu_torch.ops.icp as icp_mod
    import lili_om_tpu_torch.ops.knn as knn_mod

    from .roofline import KnnSpy

    a, b = traffic["trace_scans"]
    sys_ = window.new_session(cfg, traffic, log, device)
    window.replay(sys_, cfg, traffic, log, 0, a, device)
    cap = capture_mod.Capture(None)
    cap.annotate = True
    spy = KnnSpy().install(knn_mod, icp_mod)
    try:
        with cap.install(program.system_module()):
            path = trace.profile(lambda: window.replay(sys_, cfg, traffic, log, a, b, device,
                                                       annotate=True))
    finally:
        spy.uninstall()
    data = trace.read(path)
    return data, b - a, spy.work()


def run(cell: dict, cfg: dict, traffic: dict, reg: Registry, seed: int, seconds: float,
        traced: bool, t_start: float, device=DEVICE) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    marks = {"start": time.perf_counter() - t_start}
    if torch.device(device).type == "cuda":
        program.prepare_kernels()
    marks["kernels"] = time.perf_counter() - t_start
    log = logs.make_log(cfg, traffic, seed, device)
    window._sync(device)
    marks["log"] = time.perf_counter() - t_start
    warm(cfg, traffic, log, device)
    cap = capture_mod.Capture(capture_mod.make_plan(seed, traffic, cfg["fusion"]["window"]))
    cap.install(program.system_module())
    setup_s = time.perf_counter() - t_start
    try:
        win = window.run_window(cfg, traffic, log, seconds, device, capture=cap)
    finally:
        cap.uninstall()
    rest_s = time.perf_counter() - t_start - setup_s - win.seconds
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = check.Reference(cfg, traffic, log, device)
    gaps = check.readings(cap, ref)
    correct, numbers = check.judge(gaps, cfg.get("limits", {}), traffic)
    del cap, ref
    gc.collect()
    tm = win.timings
    print(f"benchmark: set-up {', '.join(f'{k} {v:.2f}' for k, v in marks.items())} "
          f"({', '.join(f'{k} {v:.2f}' for k, v in log.seconds.items())}), warm "
          f"{setup_s:.2f} s; window {win.seconds:.3f} s, {win.sessions} session(s), "
          f"{len(tm.scan_s)} scans, {len(tm.attempts)} attempts ({sum(tm.attempts)} with ICP), "
          f"the check's copies {sum(tm.harness_s):.3f} s left out; "
          f"the first session's rest {rest_s:.2f} s; check {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)

    values = {"scans_per_s": stats.rate(len(tm.scan_s), win.seconds),
              "scan_p95_ms": 1e3 * stats.p95(tm.scan_s),
              "closure_ms": 1e3 * stats.mean(tm.closure_s) if tm.closure_s else None,
              "setup_s": setup_s}
    name = cell["name"]
    out_metrics, breakdown, dev_extra = {}, None, {}
    if traced:
        data, n_scans, work = traced_slice(cfg, traffic, log, device)
        ctx = Context(win.stages, data, n_scans, work)
        for m in reg.metrics("per_layer", name):
            v = reg.reader(m["name"])(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": data.device_ops, "idle_gaps": data.idle_gaps}
        dev_extra = {"busy_s": data.busy_s, "window_s": data.window_s}
    else:
        for m in reg.metrics("end_to_end", name):
            v = values.get(m["name"])
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = sum(1 for n in numbers if n.limit is None or not math.isfinite(n.value)
                 or n.value > n.limit)
    result = {"correct": bool(correct), "attempted": len(tm.scan_s), "failed": failed,
              "metrics": out_metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": int(peak), **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a number that is not finite (no call came, or a gap overflowed) as a
    # string: JSON has no infinity
    result["checks"] = {n.name: {"value": n.value if math.isfinite(n.value) else str(n.value),
                                 "limit": n.limit, "calls": n.samples} for n in numbers}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    reg = Registry()
    cell = reg.workload(args.workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run(cell, cfg, traffic, reg, args.seed, args.seconds, bool(args.trace), t_start)
    bad = isolation.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
