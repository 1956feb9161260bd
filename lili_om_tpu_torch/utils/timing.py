"""Host-side wall-clock timer (tic/toc, ms): a copy of
``lili_om_tpu/utils/timing.py:15-23``, the counterpart of the reference's
hand-rolled ``Timer`` (LiLi-OM/include/utils/timer.h:10-39). Per-stage
accumulation with p50/p95 lives in :mod:`utils.metrics` (``StageMetrics``).
"""
from __future__ import annotations

import time


class Timer:
    """tic/toc in milliseconds (timer.h semantics)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3
