"""CPU tests of the readers of the program's own spans
(portbench/lib/program_spans.py, run: python -m pytest portbench -q): each
gives None on an empty registry and on a program without spans, and its
span's total over its root's count on a hand-built summary."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dcanet_tpu_torch.utils import profiling  # noqa: E402
from portbench.lib import manifest  # noqa: E402

# metric: (span, root, field)
READERS = {
    "h2d_ms.serve": ("serve.h2d", "serve.request", "host_ms"),
    "h2d_ms.serve_bf16": ("serve.h2d", "serve.request", "host_ms"),
    "d2h_wait_ms.serve": ("serve.d2h", "serve.request", "host_ms"),
    "d2h_wait_ms.serve_bf16": ("serve.d2h", "serve.request", "host_ms"),
    "cost_volume_ms.serve": ("model.cost_volume", "serve.request", "device_ms"),
    "cost_volume_ms.serve_bf16": ("model.cost_volume", "serve.request", "device_ms"),
    "fold_host_ms.serve_bf16": ("fold.lookup", "serve.request", "host_ms"),
    "step_forward_ms.train": ("model.forward", "train.step", "device_ms"),
    "step_backward_ms.train": ("train.backward", "train.step", "device_ms"),
    "optimizer_ms.train": ("train.optimizer", "train.step", "device_ms"),
    "step_issue_ms.train": ("train.step", "train.step", "host_ms"),
}


def test_every_program_span_metric_added_here_is_listed():
    bench = manifest.load_benchmark(ROOT)
    listed = {m["name"] for m in bench["per_layer"]
              if "program_spans" in (ROOT / "portbench" / "metrics" / f"{m['name']}.py").read_text()}
    assert listed == set(READERS)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_finds_nothing_without_spans(metric, monkeypatch):
    read = manifest.metric_reader(metric, ROOT)
    profiling.reset_spans()
    assert read({}) is None
    monkeypatch.delattr(profiling, "span_summary")  # a program that has no spans
    assert read({}) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_gives_its_span_per_root(metric, monkeypatch):
    span, root, field = READERS[metric]
    spans = {name: {"count": 8, "host_ms": 40.0, "self_host_ms": 20.0} for name in
             ("serve.request", "serve.h2d", "serve.d2h", "fold.lookup", "train.step")}
    spans["serve.request"]["count"] = spans["train.step"]["count"] = 4
    for name in ("model.cost_volume", "model.forward", "train.backward", "train.optimizer"):
        spans[name] = {"count": 8, "host_ms": 4.0, "self_host_ms": 4.0, "device_ms": 12.0, "device_count": 8}
    monkeypatch.setattr(profiling, "span_summary", lambda: {"spans": spans, "counters": {}, "dropped": 0})
    read = manifest.metric_reader(metric, ROOT)
    assert read({}) == pytest.approx(spans[span][field] / spans[root]["count"])
    spans.pop(span)
    assert read({}) is None
