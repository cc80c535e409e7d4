"""Statistics of a measured window.

A rate is all the work completed in the window over the whole window's
time; a percentile is taken over every request of the window, never from
medians of chunks. The longest stall is the longest stretch of the window
in which nothing completed, counted from the window's start to its end.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def rate(work: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile of all values (0 < q <= 100)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)]


def longest_stall(completions: Sequence[float], start: float, end: float) -> Tuple[float, float]:
    """(seconds, time it began) of the longest gap between the window's
    start, the completions in it, and its end."""
    marks = [start] + sorted(t for t in completions if start <= t <= end) + [end]
    gap, at = max((b - a, a) for a, b in zip(marks, marks[1:]))
    return gap, at


def serve_summary(starts: Sequence[float], ends: Sequence[float], window_start: float, window_end: float) -> dict:
    """Pairs per second and the latency percentiles of a closed loop whose
    i-th request ran from starts[i] to ends[i]."""
    latencies_ms = [1e3 * (e - s) for s, e in zip(starts, ends)]
    seconds = window_end - window_start
    stall, stall_at = longest_stall(ends, window_start, window_end)
    return {
        "requests": len(latencies_ms),
        "window_s": seconds,
        "pairs_per_s": rate(len(latencies_ms), seconds),
        "p50_ms": percentile(latencies_ms, 50),
        "p95_ms": percentile(latencies_ms, 95),
        "max_ms": max(latencies_ms),
        "stall_s": stall,
        "stall_at_s": stall_at - window_start,
    }
