"""Train and eval steps (port of dcanet_tpu/train/loop.py).

Loss presets, as the reference's trainers combine their ladders:
  * sceneflow: focal(prob ladder, w=[0.5,0.7,1.0,1.2,1.5]) +
               smooth-L1(disparity ladder, w=[1.8,2.1])   (main_dca.py:132-133)
  * kitti:     5*focal(vol_0) + 10*focal(vol_1) + smooth-L1, sparse gt
               (train_kitti.py:110-113)
  * smooth_l1: smooth-L1 only (train_eth3d.py:97-99; Middlebury)

`train_step` runs forward, loss, backward and one Adam update in place and
returns the step's metrics as detached device tensors (read them when they
are printed, so that the host does not wait on every step). While a
profiler records, it records the spans train.step > train.zero_grad,
model.forward, train.loss, train.backward, train.all_reduce,
train.optimizer, train.metrics (utils/profiling.py).

Data parallelism (a process group of W ranks, one shard of the global batch
each): BatchNorm takes the global batch's statistics and the loss terms are
each rank's share of the global loss (losses.py), so after the backward the
gradients are summed over the ranks, in one flat all-reduce in the order of
`model.parameters()`, and every rank takes the same Adam step; the metrics
are the sums of the ranks' shares. One all-reduce after the backward keeps
the collectives in one order on every rank (a DistributedDataParallel
wrapper would interleave its buckets with BatchNorm's backward ones).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dcanet_tpu_torch import losses
from dcanet_tpu_torch.parallel import distributed
from dcanet_tpu_torch.train.metrics import epe_metric, eval_metrics
from dcanet_tpu_torch.train.state import TrainState
from dcanet_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LossConfig:
    max_disp: int = 192
    focal_coefficient: float = 5.0
    sparse: bool = False
    preset: str = "sceneflow"  # sceneflow | kitti | smooth_l1
    focal_weights: Optional[Tuple[float, ...]] = None
    disparity_weights: Optional[Tuple[float, ...]] = None


def compute_loss(out, disp_gt: torch.Tensor, mask: torch.Tensor, cfg: LossConfig):
    """Combine the ladders per preset; returns (loss, dict of components)."""
    comps = {}
    if cfg.preset == "sceneflow":
        total = 0.0
        if out.prob_volumes:
            comps["focal"] = losses.focal_loss_ladder(
                out.prob_volumes, disp_gt, cfg.max_disp, cfg.focal_coefficient, cfg.sparse, cfg.focal_weights
            )
            total = comps["focal"]
        comps["smooth_l1"] = losses.model_loss(out.disparities, disp_gt, mask, cfg.disparity_weights)
        total = total + comps["smooth_l1"]
    elif cfg.preset == "kitti":
        weights = cfg.focal_weights or (5.0, 10.0)
        comps["focal"] = sum(
            w * losses.stereo_focal_loss(vol, disp_gt, cfg.max_disp, cfg.focal_coefficient, sparse=True)
            for vol, w in zip(out.prob_volumes[: len(weights)], weights)
        )
        comps["smooth_l1"] = losses.model_loss(out.disparities, disp_gt, mask, cfg.disparity_weights)
        total = comps["focal"] + comps["smooth_l1"]
    elif cfg.preset == "smooth_l1":
        comps["smooth_l1"] = losses.model_loss(out.disparities, disp_gt, mask, cfg.disparity_weights)
        total = comps["smooth_l1"]
    else:
        raise ValueError(f"unknown loss preset {cfg.preset!r}")
    comps["total"] = total
    return total, comps


def valid_mask(disp_gt: torch.Tensor, max_disp: int) -> torch.Tensor:
    """0 < gt < maxdisp (main_dca.py:127)."""
    return (disp_gt > 0.0) & (disp_gt < max_disp)


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all tensors together (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


@torch.no_grad()
def _sum_over_ranks_(tensors) -> None:
    """Sum each tensor over the ranks in place, in one flat all-reduce."""
    flat = distributed.all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]))
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """One optimisation step. batch: left/right (B, 3, H, W), disparity
    (B, H, W), on the model's device. Returns total, focal (when the preset
    has it), smooth_l1, grad_norm and epe (of the last disparity)."""
    with span("train.step"):
        model = state.model
        model.train()
        disp_gt = batch["disparity"]
        dev = disp_gt.device
        mask = valid_mask(disp_gt, cfg.max_disp)
        with span("train.zero_grad", dev):
            state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(dev.type, dtype=state.amp_dtype or torch.bfloat16, enabled=state.amp_dtype is not None):
            out = model(batch["left"], batch["right"])
        with span("train.loss", dev):
            loss, comps = compute_loss(out, disp_gt, mask, cfg)
        with span("train.backward", dev):
            loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if distributed.process_count() > 1:
            with span("train.all_reduce", dev):
                _sum_over_ranks_(grads)
        with span("train.optimizer", dev):
            grad_norm = global_norm(grads)
            state.apply_gradients()
        with span("train.metrics", dev):
            metrics = {k: v.detach() for k, v in comps.items()}
            metrics["grad_norm"] = grad_norm.detach()
            metrics["epe"] = epe_metric(out.disparities[-1].detach(), disp_gt, mask)
            if distributed.process_count() > 1:  # the ranks' shares; grad_norm is already global
                shares = [k for k in metrics if k != "grad_norm"]
                metrics.update(zip(shares, distributed.all_reduce_sum(torch.stack([metrics[k] for k in shares]))))
        return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Eval forward (running BatchNorm statistics) and EPE / D1 / >1,2,3 px."""
    model = state.model
    model.eval()
    with torch.autocast(batch["left"].device.type, dtype=state.amp_dtype or torch.bfloat16,
                        enabled=state.amp_dtype is not None):
        out = model(batch["left"], batch["right"])
    disp_gt = batch["disparity"]
    return eval_metrics(out.disparity, disp_gt, valid_mask(disp_gt, cfg.max_disp))
