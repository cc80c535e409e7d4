"""The serving driver: one client in a closed loop, one pair per request.

Each request is one call of the entry `cli infer` takes for every pair
(`cli._forward`): the whitened, padded pair goes from the host to the
device, through the model in the cell's dtype (float32 with TF32 off, or
bf16 autocast with its BatchNorm fold), and its disparity comes back to
the host. The latency of a request runs from that call to its return. The
client cycles through a pool of distinct pairs made from the seed.

Set-up: the pool, the seeded weights (their BatchNorm statistics set by the
reference over the pool's first pair), the model built on the device with
them (its widths checked against the configuration file's), and two
requests that warm the cell's one shape. The window then runs for
`seconds`; no request starts after it. A traced run hooks spans around the
model for the whole window, then profiles `trace_requests` more requests.
After the window, with the program freed, the reference computes every
pool pair once and the kept answers are held against it.

The window's rate and tail are reported as `<prefix>_pairs_per_s` and
`<prefix>_ms_p95`, the prefix the mix's `metric_prefix` (default `serve`):
cells whose runs spread alike share a name and its bound.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench.lib import compare, inputs, window
from portbench.lib.spans import ForwardSpans
from portbench.lib.trace import profile
from portbench.lib.weights import load_into_program, serving_weights
from portbench.reference import stereo


def _reference_net(config: dict, device):
    with torch.device(device):
        return stereo.from_config(config)


def _tensor(img: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(device)


def weights(config: dict, seed: int, pairs, device) -> dict:
    """The seeded weights, their BatchNorm statistics those of the reference
    over the pool's first pair (lib/weights.py)."""
    net = _reference_net(config, device)
    left, right = pairs[0]
    return serving_weights(_reference_net(config, "meta"), net, seed, _tensor(left, device), _tensor(right, device),
                           device)


def reference_disparities(config: dict, state: dict, pairs, device, tf32: bool = False, fp8: bool = False):
    """The reference's disparity of each pair with the weights `state`,
    float64 on the host; with `tf32` or `fp8`, computed in that precision
    (the check's control)."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    net = stereo.set_fp8(_reference_net(config, device), fp8)
    net.load_state_dict(state)
    net.eval()
    with torch.no_grad():
        out = [net(_tensor(left, device), _tensor(right, device))[0][0].double().cpu().numpy() for left, right in pairs]
    del net
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t_start: float = None) -> dict:
    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.models.registry import make_model

    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    bf16 = traffic["dtype"] == "bfloat16"
    log = lambda what: print(f"portbench: {what} at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)  # noqa: E731
    log("start of the driver")
    pairs = inputs.serve_pairs(seed, traffic)
    log(f"{len(pairs)} pairs made")
    state = weights(config, seed, pairs, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log("weights made")
    with torch.device("meta"):
        model = make_model(config["model"], maxdisp=config["maxdisp"])
    model = load_into_program(model.to_empty(device=dev), state, config)
    model.eval()
    if not bf16:
        cli._no_tf32(dev)
    log("model on the device")
    for i in range(2):
        cli._forward(model, *pairs[i % len(pairs)], bf16)
        log(f"warm-up request {i + 1}")
    setup_s = time.perf_counter() - t_start

    keep = np.random.default_rng([seed, 1]).random
    spans = ForwardSpans(model, config["layers"]) if trace else None
    starts, ends, served = [], [], []
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds:
        k = i % len(pairs)
        starts.append(time.perf_counter())
        disp, _ = cli._forward(model, *pairs[k], bf16)
        ends.append(time.perf_counter())
        if keep() < traffic["check_share"]:
            served.append((k, disp))
        i += 1
    stats = window.serve_summary(starts, ends, w0, ends[-1])
    prefix = traffic.get("metric_prefix", "serve")

    layer = {}
    if trace:
        layer["spans"] = spans.summary()
        spans.remove()
        n = traffic["trace_requests"]
        layer["trace"] = profile(lambda: [cli._forward(model, *pairs[j % len(pairs)], bf16) for j in range(n)])
        layer["units_traced"] = n
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refs = reference_disparities(config, state, pairs, dev)
    numbers = compare.serve_numbers(served, refs)
    return {
        "setup_s": setup_s,
        "window": stats,
        "attempted": stats["requests"],
        "failed": 0,
        "numbers": numbers,
        "compared": len(served),
        "memory_peak_bytes": peak,
        "layer": layer,
        "metrics": {f"{prefix}_pairs_per_s": stats["pairs_per_s"], f"{prefix}_ms_p95": stats["p95_ms"],
                    "setup_s": setup_s},
    }
