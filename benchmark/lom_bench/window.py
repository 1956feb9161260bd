"""The timed window: the log replayed as back-to-back sessions, each with a
fresh ``LiliOmSystem`` that is given the session's IMU stream and then
every scan in stamp order, with a loop-closure attempt after every
``closure_every``-th scan, all in one thread. Each scan's time runs from
the ``process_scan*`` call to its return and a synchronize; each attempt's
the same around ``try_loop_closure``. The check's copies of what a scan or
attempt produced are made after its synchronize, and their time is left
out of the window's seconds."""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from . import program


class Timings(NamedTuple):
    scan_s: list  # every scan's time
    closure_s: list  # every attempt that ran ICP
    attempts: list  # one per attempt: 1 if it ran ICP, else 0
    harness_s: list  # the check's copies, made between the timed spans


def new_timings() -> Timings:
    return Timings([], [], [], [])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span(name: str, on: bool):
    return torch.profiler.record_function(f"bench.{name}") if on else contextlib.nullcontext()


def new_session(cfg, traffic, log, device):
    sys_ = program.build_system(cfg, traffic, device)
    sys_.push_imu(*log.imu)
    return sys_


def _flush(capture, timings, device):
    """The check's copies of the ended scan or attempt, synchronised and
    timed apart."""
    if capture is None or not capture.dirty():
        return
    t0 = time.perf_counter()
    capture.flush()
    _sync(device)
    if timings is not None:
        timings.harness_s.append(time.perf_counter() - t0)


def replay(sys_, cfg, traffic, log, start: int, stop: int, device, timings=None,
           capture=None, deadline=None, annotate=False) -> int:
    """Scans [start, stop) of the log through ``sys_``; stops early after
    the first scan (and its attempt) that ends past ``deadline``, which
    moves on by the time of the check's copies. Returns the index of the
    next scan."""
    every = traffic["closure_every"]
    for k in range(start, stop):
        if capture is not None:
            capture.begin_scan(k, log.stamps[k])
        t0 = time.perf_counter()
        with _span("scan", annotate):
            program.process(sys_, cfg, log.scans[k], log.stamps[k])
        _sync(device)
        t1 = time.perf_counter()
        if timings is not None:
            timings.scan_s.append(t1 - t0)
        _flush(capture, timings, device)
        if (k + 1) % every == 0:
            n_icp = len(sys_.metrics.samples.get("icp", ()))
            t0 = time.perf_counter()
            with _span("closure", annotate):
                fired = sys_.try_loop_closure()
            _sync(device)
            dt = time.perf_counter() - t0
            ran_icp = len(sys_.metrics.samples.get("icp", ())) > n_icp
            if timings is not None:
                timings.attempts.append(int(ran_icp))
                if ran_icp:
                    timings.closure_s.append(dt)
            _flush(capture, timings, device)
            if capture is not None:
                capture.after_closure(fired)
        if deadline is not None and time.perf_counter() >= deadline + _spent(timings):
            return k + 1
    return stop


def _spent(timings) -> float:
    return sum(timings.harness_s) if timings is not None else 0.0


class Window(NamedTuple):
    seconds: float  # from the first session's start to the last scan's end, less the copies
    timings: Timings
    stages: dict  # stage name -> every sample of the window's sessions (s)
    sessions: int


def run_window(cfg, traffic, log, seconds: float, device, capture=None) -> Window:
    """Sessions back to back until ``seconds`` have passed; the scan (and
    attempt) under way at the deadline completes and counts. Where the
    first session has not reached every planned capture by then, it goes
    on after the window, untimed, until they have come."""
    n = traffic["scans_per_session"]
    timings = new_timings()
    stages: dict = {}
    t_open = time.perf_counter()
    deadline = t_open + seconds
    first, first_at, sessions = None, n, 0
    while True:
        sys_ = new_session(cfg, traffic, log, device)
        cap = capture if sessions == 0 else None
        at = replay(sys_, cfg, traffic, log, 0, n, device, timings, cap, deadline)
        for name, xs in sys_.metrics.samples.items():
            stages.setdefault(name, []).extend(xs)
        if sessions == 0:
            first, first_at = sys_, at
            if capture is not None and at == n:
                capture.end_session()
        sessions += 1
        if time.perf_counter() >= deadline + _spent(timings):
            break
        if sessions == 1:
            first = None
    window_s = time.perf_counter() - t_open - _spent(timings)
    while capture is not None and first is not None and first_at < n and capture.pending():
        first_at = replay(first, cfg, traffic, log, first_at, first_at + 1, device, None, capture)
    if capture is not None:
        capture.end_session()
    return Window(window_s, timings, stages, sessions)
