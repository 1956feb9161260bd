"""The arithmetic of the end-to-end metrics and of the device's busy time."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def rate(count: int, seconds: float) -> float:
    """Work over the whole window: ``count`` items in ``seconds``."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value (linear interpolation between
    order statistics, numpy's default)."""
    if len(values) == 0:
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def mean(values: Sequence[float]) -> float | None:
    """The mean, or None for no values (a metric with nothing to read)."""
    return float(np.mean(values)) if len(values) else None


def merged_busy(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps of ``[lo, hi]`` that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]
