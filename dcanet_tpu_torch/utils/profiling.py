"""Tracing and timing (port of dcanet_tpu/utils/profiling.py).

  * `trace(logdir)` — context manager around `torch.profiler.profile`
    (CPU and CUDA activities) that writes a Chrome / TensorBoard trace JSON
    under `logdir` when it exits (no tensorboard package needed).
  * `device_time(fn, *args)` — seconds per call of `fn(*args)`: CUDA events
    around each call for tensors on the card, the host clock for tensors on
    the CPU.
  * `StepTimer` — wall-clock steps / pairs per second for the train loop.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the trace (`*.pt.trace.json`, per-kernel device
    times on CUDA) lands in `logdir` when the body ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _on_cuda(args) -> bool:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        raise ValueError("device_time needs at least one tensor argument to know its device")
    devices = {t.device.type for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"device_time got tensors on {sorted(devices)}; put them on one device")
    return devices == {"cuda"}


def device_time(fn: Callable, *args, iters: int = 10, salt_arg: int = 0) -> float:
    """Median seconds per call of `fn(*args)` over `iters` calls, after two
    warm-up calls. The tensors' device picks the clock: on CUDA, an event
    pair recorded around each call (device time of the call's kernels, the
    host's launch gaps included when the host falls behind); on the CPU,
    `time.perf_counter` around each call.

    `salt_arg` is accepted for the JAX signature and unused: the JAX version
    chains the calls inside one compiled loop through that argument, which
    eager PyTorch does not need, as every call runs.
    """
    del salt_arg
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    cuda = _on_cuda(args)
    for _ in range(2):
        fn(*args)
    if cuda:
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            s.record()
            fn(*args)
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends)) / 1e3
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class StepTimer:
    """Steps and pairs per second since the last `reset`."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size
