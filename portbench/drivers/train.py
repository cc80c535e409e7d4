"""The training driver: the preset's train step on a resident batch.

Set-up builds the train state as `cli train` does
(`cli.build_train_state` of the preset, the model's weights then replaced
by the seeded ones and its widths checked against the configuration
file's), a pool of distinct batches on the device, and drives that state
through its first `checked_steps` steps, one batch each, through the
window's own call (`train.loop.train_step`). Those steps are the warm-up
and what the check reads: each step's loss, the first gradient (from
Adam's first moment after one step) and each leaf's change after them.
The window then dispatches steps on the same state, one pool batch after
another, without reading a metric, and ends on a synchronize. With the
program freed, the reference makes the checked steps again from the same
weights and batches.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from portbench.lib import compare, inputs
from portbench.lib.trace import profile
from portbench.lib.weights import load_into_program, seeded_state_dict
from portbench.reference import stereo
from portbench.reference import train as reference_train


def _layout(config: dict):
    with torch.device("meta"):
        return stereo.from_config(config)


def program_run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """The program's set-up, checked steps, window and traced steps; its
    numbers, JSON-able."""
    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.parallel import initialize, make_mesh, replicate, shard_batch
    from dcanet_tpu_torch.train import loop

    config, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    log = lambda what: print(f"portbench: {what} at +{time.perf_counter() - t0:.3f} s", file=sys.stderr)  # noqa: E731
    dev = initialize(None, 1, 0, device=torch.device(device))
    mesh = make_mesh()
    cfg = preset(traffic["preset"], dtype=traffic["dtype"], model=config["model"], maxdisp=config["maxdisp"], seed=0)
    state = cli.build_train_state(cfg, traffic["steps_per_epoch"], str(dev), mesh)
    weights = seeded_state_dict(_layout(config), seed, dev)
    load_into_program(state.model, weights, config)
    replicate(state.model, mesh)
    if cfg.dtype == "float32":
        cli._no_tf32(dev)
    loss_cfg = loop.LossConfig(max_disp=cfg.maxdisp, focal_coefficient=cfg.focal_coefficient, sparse=cfg.sparse_gt,
                               preset=cfg.loss_preset)
    pool = [shard_batch(b, mesh) for b in inputs.train_batches(seed, traffic, dev)]
    log("train state and batches on the device")
    params = dict(state.model.named_parameters())
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    losses, grad_norms = [], {}
    for i in range(traffic["checked_steps"]):
        metrics = loop.train_step(state, pool[i % len(pool)], loss_cfg)
        losses.append(metrics["total"])
        if i == 0:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            moments = {k: state.optimizer.state[p]["exp_avg"] for k, p in params.items() if p in state.optimizer.state}
            grad_norms = {k: float(m.norm()) / (1 - beta1) for k, m in moments.items()}
        sync()
        log(f"checked step {i + 1}")
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    losses = [float(x) for x in losses]
    del weights
    setup_end = time.time()

    done, window_losses = traffic["checked_steps"], []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        window_losses.append(loop.train_step(state, pool[done % len(pool)], loss_cfg)["total"])
        done += 1
    sync()
    window_s = time.perf_counter() - w0
    failed = sum(1 for x in window_losses if not math.isfinite(float(x)))

    out = {"setup_end": setup_end, "window_s": window_s, "steps": len(window_losses), "failed": failed,
           "losses": losses, "grad_norms": grad_norms, "change_norms": change}
    if trace:
        n = traffic["trace_steps"]
        out["trace"] = profile(lambda: [loop.train_step(state, pool[(done + j) % len(pool)], loss_cfg)
                                        for j in range(n)])
        out["steps_traced"] = n
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return out


def reference_steps(config: dict, traffic: dict, seed: int, device, fp8: bool = False, half_batch: bool = False,
                    amp=None) -> dict:
    """The reference's checked steps on the batches, float32 with TF32 off;
    `fp8` and `half_batch` make the check's control and a fault, `amp` (a
    dtype under autocast) a witness at the program's precision for
    portbench/calibrate.py."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = stereo.set_fp8(stereo.from_config(config), fp8).to(device)
    net.load_state_dict(seeded_state_dict(_layout(config), seed, device))
    pool = inputs.train_batches(seed, traffic, device)
    rows = traffic["batch"] // 2 if half_batch else traffic["batch"]
    batches = [(b["left"][:rows], b["right"][:rows], b["disparity"][:rows])
               for b in (pool[i % len(pool)] for i in range(traffic["checked_steps"]))]
    del pool
    out = reference_train.train_steps(net, batches, amp=amp)
    del net, batches
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t_start: float = None) -> dict:
    t_start_wall = time.time() - (time.perf_counter() - t_start if t_start is not None else 0.0)
    config, traffic = cell.config, cell.traffic
    prog = program_run(cell, seed, seconds, trace, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(config, traffic, seed, torch.device(device))
    numbers = compare.train_numbers(prog, ref)
    pairs_per_s = prog["steps"] * traffic["batch"] / prog["window_s"]
    setup_s = prog["setup_end"] - t_start_wall
    layer = {}
    if trace:
        layer["trace"] = prog["trace"]
        layer["units_traced"] = prog["steps_traced"]
    return {
        "setup_s": setup_s,
        "window": {"steps": prog["steps"], "window_s": prog["window_s"], "pairs_per_s": pairs_per_s},
        "attempted": prog["steps"],
        "failed": prog["failed"],
        "numbers": numbers,
        "compared": len(prog["losses"]),
        "memory_peak_bytes": prog["memory_peak_bytes"],
        "layer": layer,
        "metrics": {"train_pairs_per_s": pairs_per_s, "setup_s": setup_s},
    }
