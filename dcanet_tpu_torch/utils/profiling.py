"""Tracing and timing (port of dcanet_tpu/utils/profiling.py), and the
port's own spans and counters.

  * `trace(logdir)` — context manager around `torch.profiler.profile`
    (CPU and CUDA activities) that writes a Chrome / TensorBoard trace JSON
    under `logdir` when it exits (no tensorboard package needed), and
    beside it `spans.json`: `span_summary()` of the body and its raw spans.
  * `device_time(fn, *args)` — seconds per call of `fn(*args)`: CUDA events
    around each call for tensors on the card, the host clock for tensors on
    the CPU.
  * `StepTimer` — wall-clock steps / pairs per second for the train loop.
  * `span(name, device)`, `span_summary()`, `span_records()`,
    `reset_spans()`, `counters()`, `reset_counters()` — below.

Spans record only while a torch profiler records
(`torch.autograd.profiler._is_profiler_enabled`, which
`torch.profiler.profile` sets: `trace(logdir)` and the benchmark's traced
stretch). Otherwise `span` is one flag check and returns a shared no-op
context. A recording span keeps its name, its host start and end
(`time.perf_counter_ns`), the id of the span open around it and the id of
its root (one root per request or train step), and opens a plain profiler
range of its name, so that it lands in the profiler's CPU timeline on the
kernels' clock. The range is not a user annotation (`record_function`):
Kineto copies those onto the GPU timeline, where they would read as device
work. Given a CUDA device, a span also records a CUDA event pair on that
device's current stream; the events are read only by `span_summary()`,
after one synchronize. No span synchronizes. Per-name aggregates are kept
always; raw spans and event pairs up to `SPAN_CAP`, then counted as dropped.

The spans (parent > child), and what reads them:

  serve.request (root)  cli._forward, one served pair
    serve.h2d           its two uploads and the synchronize after them
    model.forward       the model's forward (below)
    serve.d2h           the disparity to the host, blocked on the forward
  train.step (root)     train/loop.py::train_step (host only)
    train.zero_grad, model.forward, train.loss, train.backward,
    train.all_reduce (the gradient's sum, more than one rank),
    train.optimizer (global_norm and Adam), train.metrics
  model.forward         DCANet / GwcNetBaseline.forward (models/dcanet.py)
    model.features, model.guidance (DCANet), model.cost_volume (the gwc
    kernel and the concat volume), model.aggregation (dres, CVA blocks or
    hourglasses, the classif heads), model.regression (softmax and
    soft-argmin), model.propagation (DCANet's convex upsampling)
  fold.lookup           a host accumulator, no range and no parent:
                        nn/layers.py::conv_bn's fold branch
                        (`fold_eval_bn_enabled` and `_folded`)

Every span under model.forward and train.* carries device events on CUDA.
The benchmark's per-layer readers (`portbench/metrics/`) divide a span's
host or device ms by its root's count.

Counters, read where the work counts them, by `counters()`; set to 0 by
`reset_counters()` (the kernels' module attributes and
`kernels/gwc.py::reset_launch_counts` stay for their callers):

  fold.lookups, fold.rebuilds   nn/layers.py::_folded: calls, and folds
                                computed (cache misses; every call of the
                                uncached case)
  collective.all_reduce,        parallel/distributed.py::all_reduce_: each
  collective.all_reduce_bytes   sum over ranks (both directions of
                                all_reduce_sum, the disparity halos and
                                gathers) and its bytes
  data.batches, data.wait_s     data/loader.py::waited: the batches cmd_train
                                took from device_prefetch and the host
                                seconds it waited for them
  gwc.*, conv3d.*               the kernels' launch counts
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the trace (`*.pt.trace.json`, per-kernel device
    times on CUDA) and `spans.json` (`span_summary()` and `span_records()`
    of the body's spans) land in `logdir` when the body ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_spans()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(dict(span_summary(), records=span_records()), f)


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
    import statistics  # here, so that importing the port (which imports `span`) loads no more modules

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


# ---- spans and counters (see the module docstring) ----

_PROFILER = torch.autograd.profiler
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)  # a plain range, not a user annotation
SPAN_CAP = 10_000  # raw spans, and spans with device events, kept until `reset_spans`


class _Aggregate:
    __slots__ = ("count", "host_ns", "self_ns", "device_ms", "device_count")

    def __init__(self):
        self.count = self.host_ns = self.self_ns = self.device_count = 0
        self.device_ms = 0.0


class _Registry:
    def __init__(self):
        self.local = threading.local()  # .stack: the spans open in this thread
        self.reset()

    def reset(self) -> None:
        self.ids = itertools.count(1)
        self.aggregates: Dict[str, _Aggregate] = {}
        self.records: List[dict] = []
        self.pending: list = []  # (aggregate, record or None, device, start event, end event)
        self.dropped = 0

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def aggregate(self, name: str) -> _Aggregate:
        agg = self.aggregates.get(name)
        if agg is None:
            agg = self.aggregates[name] = _Aggregate()
        return agg


_REGISTRY = _Registry()


class _Span:
    __slots__ = ("name", "device", "id", "parent", "root", "range", "ev0", "t0", "child_ns")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.child_ns = name, 0
        cuda = device is not None and device.type == "cuda"
        self.device = device if cuda and len(_REGISTRY.pending) < SPAN_CAP else None

    def __enter__(self):
        stack = _REGISTRY.stack()
        parent = stack[-1] if stack else None
        self.id = next(_REGISTRY.ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        stack.append(self)
        self.range = _RANGE(self.name) if _RANGE is not None else None
        if self.range is not None:
            self.range.__enter__()
        self.ev0 = _event(self.device) if self.device is not None else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        ev1 = _event(self.device) if self.device is not None else None
        if self.range is not None:
            self.range.__exit__(None, None, None)
        reg = _REGISTRY
        stack = reg.stack()
        stack.pop()
        took = t1 - self.t0
        if stack:
            stack[-1].child_ns += took
        agg = reg.aggregate(self.name)
        agg.count += 1
        agg.host_ns += took
        agg.self_ns += took - self.child_ns
        record = None
        if len(reg.records) < SPAN_CAP:
            record = dict(name=self.name, id=self.id, parent=self.parent, root=self.root, start_ns=self.t0,
                          end_ns=t1)
            reg.records.append(record)
        else:
            reg.dropped += 1
        if ev1 is not None:
            reg.pending.append((agg, record, self.device, self.ev0, ev1))
        return False


def _event(device: torch.device) -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans record: a torch profiler is recording."""
    return _PROFILER._is_profiler_enabled


def span(name: str, device: Optional[torch.device] = None):
    """A context that records the span `name` while a profiler records, with
    CUDA events on `device`'s current stream when it is a CUDA device; a
    shared no-op context otherwise."""
    if not _PROFILER._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def add_host_time(name: str, start_ns: int) -> None:
    """Add the host time from `start_ns` (`time.perf_counter_ns`) to now to
    the aggregate `name`, once: a host accumulator, with no range, no
    parent and no raw record (fold.lookup)."""
    agg = _REGISTRY.aggregate(name)
    took = time.perf_counter_ns() - start_ns
    agg.count += 1
    agg.host_ns += took
    agg.self_ns += took


def _resolve() -> None:
    """Read every pending event pair, after one synchronize of each device
    they were recorded on."""
    reg = _REGISTRY
    if not reg.pending:
        return
    for device in {p[2] for p in reg.pending}:
        torch.cuda.synchronize(device)
    for agg, record, _, ev0, ev1 in reg.pending:
        ms = ev0.elapsed_time(ev1)
        agg.device_ms += ms
        agg.device_count += 1
        if record is not None:
            record["device_ms"] = ms
    reg.pending = []


def span_summary() -> dict:
    """{"spans": {name: {count, host_ms, self_host_ms[, device_ms,
    device_count]}}, "counters": counters(), "dropped": raw spans not kept}.
    Totals over every span of a name since `reset_spans`; self host time
    is a span's time less what its child spans cover."""
    _resolve()
    spans = {}
    for name, agg in _REGISTRY.aggregates.items():
        entry = {"count": agg.count, "host_ms": agg.host_ns / 1e6, "self_host_ms": agg.self_ns / 1e6}
        if agg.device_count:
            entry.update(device_ms=agg.device_ms, device_count=agg.device_count)
        spans[name] = entry
    return {"spans": spans, "counters": counters(), "dropped": _REGISTRY.dropped}


def span_records() -> List[dict]:
    """The raw spans kept (at most SPAN_CAP), in the order they ended:
    name, id, parent, root, start_ns, end_ns and, once resolved, device_ms."""
    _resolve()
    return list(_REGISTRY.records)


def reset_spans() -> None:
    """Forget every span recorded, its aggregates and its pending events."""
    _REGISTRY.reset()


# (counter, module, attribute): the counts live where the work happens; a
# module not yet imported has counted nothing, so it is not imported here
_COUNTERS = (
    ("fold.lookups", "dcanet_tpu_torch.nn.layers", "FOLD_LOOKUPS"),
    ("fold.rebuilds", "dcanet_tpu_torch.nn.layers", "FOLD_REBUILDS"),
    ("collective.all_reduce", "dcanet_tpu_torch.parallel.distributed", "ALL_REDUCES"),
    ("collective.all_reduce_bytes", "dcanet_tpu_torch.parallel.distributed", "ALL_REDUCE_BYTES"),
    ("data.batches", "dcanet_tpu_torch.data.loader", "BATCHES"),
    ("data.wait_s", "dcanet_tpu_torch.data.loader", "WAIT_S"),
    ("gwc.launches", "dcanet_tpu_torch.kernels.gwc", "LAUNCHES"),
    ("gwc.backward_launches", "dcanet_tpu_torch.kernels.gwc", "BACKWARD_LAUNCHES"),
    ("gwc.range_backward_launches", "dcanet_tpu_torch.kernels.gwc", "RANGE_BACKWARD_LAUNCHES"),
    ("gwc.launches_by_dtype", "dcanet_tpu_torch.kernels.gwc", "LAUNCHES_BY_DTYPE"),
    ("gwc.backward_launches_by_dtype", "dcanet_tpu_torch.kernels.gwc", "BACKWARD_LAUNCHES_BY_DTYPE"),
    ("conv3d.launches", "dcanet_tpu_torch.kernels.conv3d", "LAUNCHES"),
    ("conv3d.bf16_launches", "dcanet_tpu_torch.kernels.conv3d", "BF16_LAUNCHES"),
)


def counters() -> Dict[str, float]:
    """Every counter by name; a per-dtype count as `<name>.<dtype>`."""
    out: Dict[str, float] = {}
    for name, module, attr in _COUNTERS:
        value = getattr(sys.modules.get(module), attr, 0)
        if isinstance(value, dict):
            out.update((f"{name}.{k}", v) for k, v in value.items())
        else:
            out[name] = value
    return out


def reset_counters() -> None:
    """Set every counter of `counters()` to 0."""
    for _, module, attr in _COUNTERS:
        mod = sys.modules.get(module)
        if mod is None:
            continue
        value = getattr(mod, attr)
        if isinstance(value, dict):
            for k in value:
                value[k] = 0
        else:
            setattr(mod, attr, type(value)(0))
