"""What the per-layer metrics' readers (portbench/metrics/*.py) share.

A reader gets `ctx`: the cell (`ctx["cell"]`), the host clock's window
(`ctx["window"]`), the profiled stretch's summary (`ctx["trace"]`, see
lib/trace.py) and the requests or steps it covered (`ctx["units_traced"]`),
and in serving cells the spans of the model's forwards (`ctx["spans"]`,
lib/spans.py). It returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

from typing import Optional, Tuple

from portbench.lib import flops, roofline

GWC_FORWARD = "gwc_volume_kernel"
GWC_BACKWARD = "gwc_volume_backward_kernel"


def ops_matching(ctx: dict, needle: str) -> Tuple[int, float]:
    """(launches, seconds) of the traced device operations whose name holds `needle`."""
    n, s = 0, 0.0
    for name, (count, seconds) in ctx["trace"]["ops"].items():
        if needle.lower() in name.lower():
            n, s = n + count, s + seconds
    return n, s


def _gwc_shape(ctx: dict):
    """(feature shape, groups, planes, bytes per element) of the cell's gwc volume."""
    cfg, traffic = ctx["cell"].config, ctx["cell"].traffic
    h, w = traffic["input_hw"] if traffic["kind"] == "serve" else traffic["crop_hw"]
    b = 1 if traffic["kind"] == "serve" else traffic["batch"]
    elem = 2 if traffic["dtype"] == "bfloat16" else 4
    return (b, cfg["feature_channels"], h // 4, w // 4), cfg["num_groups"], cfg["maxdisp"] // 4, elem


def gwc_roofline(ctx: dict, backward: bool) -> Optional[float]:
    """The kernel's least time at the cell's shape over its traced time per
    launch, in %."""
    n, seconds = ops_matching(ctx, GWC_BACKWARD if backward else GWC_FORWARD)
    if n == 0 or seconds <= 0:
        return None
    bound = roofline.gwc_backward_bound_ms if backward else roofline.gwc_bound_ms
    return 100.0 * bound(*_gwc_shape(ctx)) * n / (1e3 * seconds)


def idle_pct(ctx: dict) -> Optional[float]:
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(ctx: dict) -> Optional[float]:
    """The reference's operations of the window's work over the window's
    time (host clock), against the cell dtype's peak on all its cards, in %."""
    cfg, traffic = ctx["cell"].config, ctx["cell"].traffic
    serve = traffic["kind"] == "serve"
    hw = traffic["input_hw"] if serve else traffic["crop_hw"]
    batch = 1 if serve else traffic["batch"]
    per_unit = flops.count(cfg, batch, hw, not serve)
    units_per_s = ctx["window"]["pairs_per_s"] / batch
    return 100.0 * per_unit * units_per_s / (roofline.MFU_PEAK[traffic["dtype"]] * ctx["cell"].chips)
