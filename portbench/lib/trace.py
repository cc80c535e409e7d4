"""A profiled stretch of the timed path, reduced to plain numbers.

`profile(fn)` runs fn under torch.profiler (CPU and CUDA activities) and
returns a JSON-able summary:

  window_s    from the first event of the stretch to the last
  busy_s      the union of the device's operation intervals (kernels,
              copies, sets): overlapping kernels count once
  ops         {name: [count, seconds]} of every device operation
  device_ops  the 10 that took most time, [[name, seconds], ...]
  idle_gaps   the 10 longest stretches with no device operation, each named
              by the innermost host operation running at its middle
              ("between host operations": the host ran Python then)
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

NAME_CHARS = 120


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def summarize(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]]) -> Dict:
    """device / host: (name, start_us, end_us) of the device's operations
    and of the host's."""
    if not device:
        return {"window_s": 0.0, "busy_s": 0.0, "ops": {}, "device_ops": [], "idle_gaps": []}
    start = min(s for _, s, _ in device + host)
    end = max(e for _, _, e in device + host)
    busy = _union([(s, e) for _, s, e in device])
    ops: Dict[str, List[float]] = {}
    for name, s, e in device:
        entry = ops.setdefault(name[:NAME_CHARS], [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) / 1e6
    marks = [start] + [t for iv in busy for t in iv] + [end]
    gaps = sorted(((b - a, a) for a, b in zip(marks[::2], marks[1::2]) if b > a), reverse=True)[:10]
    idle = []
    for length, at in gaps:
        mid = at + length / 2
        covering = [(e - s, n) for n, s, e in host if s <= mid <= e]
        idle.append([min(covering)[1][:NAME_CHARS] if covering else "between host operations", length / 1e6])
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (end - start) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "ops": ops,
        "device_ops": [[n, v[1]] for n, v in top],
        "idle_gaps": idle,
    }


def profile(fn: Callable[[], None]) -> Dict:
    """fn() under the profiler, the device synchronised on both sides."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        rec = (ev.name, ev.time_range.start, ev.time_range.end)
        (device if ev.device_type == DeviceType.CUDA else host).append(rec)
    out = summarize(device, host)
    out["host_wall_s"] = wall
    return out
