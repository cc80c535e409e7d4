"""The program's own spans and counters (dcanet_tpu_torch/utils/profiling.py),
for the per-layer metrics whose source is `program_span`.

The program records spans only while a torch profiler records, so after a
run its registry holds the traced stretch (lib/trace.py::profile) and
nothing else. A metric is one span name's host or device ms over the count
of its root span: `serve.request` (one a request) or `train.step` (one a
step). A program without the spans, or without the span or root asked for,
gives None.
"""

from __future__ import annotations

from typing import Optional


def span_summary() -> Optional[dict]:
    """The program's `span_summary()`, or None where it has none."""
    try:
        from dcanet_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "span_summary", None)
    return read() if read is not None else None


def per_root(name: str, root: str, field: str) -> Optional[float]:
    """`field` ("host_ms" or "device_ms") of the spans `name`, summed, over
    the count of the spans `root`."""
    spans = (span_summary() or {}).get("spans", {})
    span, base = spans.get(name), spans.get(root)
    if not span or not base or not base.get("count") or field not in span:
        return None
    return span[field] / base["count"]
