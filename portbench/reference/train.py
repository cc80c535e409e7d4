"""The KITTI fine-tune step in plain PyTorch: the benchmark's frozen reference.

The loss is the published KITTI trainer's (DCANet train_kitti.py:110-113):
5 x the stereo focal loss of the first probability volume, 10 x that of the
second, on the sparse gt (max-pooled to the volume's scale), plus the
smooth-L1 ladder (weights 1.8, 2.1) over the pixels 0 < gt < maxdisp. The
focal loss (models/loss.py:206-240) takes the model's softmaxed volumes
through log_softmax as they are, as the published code does, puts masked
pixels in its mean's denominator and adds 1e-40 to the Laplace gt
probabilities. The step is DCANet's: its train forward returns the
probability volumes and the disparities this loss reads.

Adam is optax's and torch's: betas (0.9, 0.999), eps 1e-8, bias-corrected
moments, the rate of the KITTI schedule (1e-3 for the first 300 epochs).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _smooth_l1(pred, target):
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def _laplace_prob(gt, d):
    """softmax over k of -|k - gt|, zero where not 0 < gt < d - 1, + 1e-40."""
    k = torch.arange(d, dtype=gt.dtype, device=gt.device).view(1, d, 1, 1)
    mask = ((gt > 0) & (gt < d - 1)).to(gt.dtype)[:, None]
    return (-(k - (gt * mask[:, 0])[:, None]).abs()).softmax(1) * mask + 1e-40


def focal_loss(est, gt, maxdisp: int, coefficient: float = 5.0):
    b, d, h, w = est.shape
    scale = gt.shape[-1] // w
    g = (gt / scale).view(b, h, scale, w, scale).amax((2, 4))
    mask = ((g > 0) & (g < maxdisp // scale)).to(est.dtype)
    prob = _laplace_prob(g * mask, maxdisp // scale)
    return (-(prob * est.log_softmax(1) * (1.0 - prob) ** (-coefficient)).sum(1) * mask).mean()


def kitti_loss(probs: List[torch.Tensor], disps: List[torch.Tensor], gt, maxdisp: int):
    mask = (gt > 0) & (gt < maxdisp)
    focal = sum(w * focal_loss(p, gt, maxdisp) for p, w in zip(probs[:2], (5.0, 10.0)))
    return focal + sum(w * _masked_mean(_smooth_l1(d, gt), mask) for d, w in zip(disps, (1.8, 2.1)))


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps, self.t = params, lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            if p.grad is None:
                continue
            self.m[k].mul_(b1).add_(p.grad, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + self.eps
            p.sub_(self.lr * (self.m[k] / (1 - b1 ** self.t)) / denom)


def train_steps(model, batches, lr: float = 1e-3, amp=None) -> Dict[str, object]:
    """Steps of the model in train mode, one for each (left, right, gt) of
    `batches`. Returns each step's loss, each leaf's gradient norm at the
    first step and the norm of each leaf's change over all the steps. With
    `amp` (a dtype) the forward and the loss run under autocast to it."""
    model.train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, lr)
    losses, grad_norms = [], {}
    for i, (left, right, gt) in enumerate(batches):
        for p in params.values():
            p.grad = None
        with torch.autocast(left.device.type, dtype=amp, enabled=amp is not None):
            probs, disps = model(left, right)
            loss = kitti_loss(probs, disps, gt, model.maxdisp)
        loss.backward()
        if i == 0:
            grad_norms = {k: float(p.grad.norm()) for k, p in params.items() if p.grad is not None}
        opt.step()
        losses.append(float(loss.detach()))
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
