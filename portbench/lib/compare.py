"""The numbers that decide `correct`, and their limits.

Serving: every served disparity that the check keeps is held against the
reference's disparity of the same pair. `disp_mean_gap_px` is the worst
request's mean absolute gap, `disp_max_gap_px` the largest gap of any pixel
of any request, `disp_far_share` the worst request's share of pixels more
than 1 px off.

Training: the first steps' losses, the first gradient and the change the
steps make:
  loss_gap         max over the steps of |loss - ref| / |ref|; loss1_gap the first step's
  grad_gap         max over the leaves of | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|)
  grad_median_gap  the median over the leaves of | |g| - |g_ref| | / |g_ref|
  grad_total_gap   the same of the whole gradient's norm
  change_gap       grad_gap's form of the leaves' change over the steps, leaving
                   out the leaves whose reference gradient is under a thousandth
                   of the median leaf's: they move under Adam by round-off alone
                   (a bias before a BatchNorm)
  change_median_gap  grad_median_gap's form of the change, over the same leaves:
                   the steady form that a cell compares, since the worst leaf's
                   change is that of a BatchNorm's 32-128 scales or shifts, whose
                   three sign-like Adam steps flip with any rounding of a
                   near-zero gradient (PERF.md, the train cell's look)
A cell's limits file names the numbers it compares; the others are
readings for `portbench/calibrate.py`.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np


def serve_numbers(served: List[Tuple[int, np.ndarray]], refs: List[np.ndarray]) -> Dict[str, float]:
    out = {"disp_mean_gap_px": 0.0, "disp_max_gap_px": 0.0, "disp_far_share": 0.0}
    for pair, disp in served:
        gap = np.abs(disp.astype(np.float64) - refs[pair])
        if not np.all(np.isfinite(gap)):
            return {k: math.inf for k in out}
        for k, v in (("disp_mean_gap_px", gap.mean()), ("disp_max_gap_px", gap.max()),
                     ("disp_far_share", (gap > 1.0).mean())):
            out[k] = max(out[k], float(v))
    return out


def _gap(x: float) -> float:
    """A gap, with NaN read as infinitely far."""
    return x if not math.isnan(x) else math.inf


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], keys) -> float:
    median = statistics.median(want[k] for k in keys)
    return max(_gap(abs(got.get(k, 0.0) - want[k]) / max(want[k], median)) for k in keys)


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    losses = [_gap(abs(a - b) / abs(b)) for a, b in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(math.inf)
    g_ref = reference["grad_norms"]
    median = statistics.median(g_ref.values())
    moved = [k for k in reference["change_norms"] if g_ref.get(k, 0.0) >= 1e-3 * median]
    total = lambda d: math.sqrt(sum(v * v for v in d.values()))  # noqa: E731
    rel = lambda k, got, want: abs(got.get(k, 0.0) - want[k]) / max(want[k], 1e-30)  # noqa: E731
    return {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": _worst_leaf(program["grad_norms"], g_ref, list(g_ref)),
        "grad_median_gap": statistics.median(_gap(rel(k, program["grad_norms"], g_ref)) for k in g_ref),
        "grad_total_gap": _gap(abs(total(program["grad_norms"]) - total(g_ref)) / total(g_ref)),
        "change_gap": _worst_leaf(program["change_norms"], reference["change_norms"], moved),
        "change_median_gap": statistics.median(_gap(rel(k, program["change_norms"], reference["change_norms"]))
                                               for k in moved),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """correct: a limit for the cell exists and every number that has one is
    finite and within it. Returns (correct, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks or {k: {"value": v, "limit": None} for k, v in numbers.items()}
