"""Semantic-level context (SLC) class pooling, dense one-hot form.

Port of dcanet_tpu/ops/slc.py. Per pixel p, with probabilities
P = softmax(logits, D), class a_p = argmax_D P and score s_p = max_D P:

  onehot[p, d] = [a_p == d]
  M_d          = max_{p: a_p=d} s_p          (class max, for a stable softmax)
  e_p          = exp(s_p - M_{a_p})
  Z_d          = sum_{p: a_p=d} e_p
  weight_p     = e_p / Z_{a_p}
  out[:, d, p] = onehot[p, d] * weight_p * x[:, a_p, p]

Every sum and max here is a broadcast against the one-hot mask. The
statistics are computed in the logits' dtype, which the caller chooses
(nn/cva.py: the model's dtype in eval, as the JAX package; float32 in
training).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def slc_pool(x: torch.Tensor, logits: torch.Tensor, shard=None) -> torch.Tensor:
    """x: (B, C, D, H, W) cost-volume features; logits: (B, D, H, W) raw
    classification logits over D. Returns (B, C, D, H, W), zero except at each
    pixel's argmax plane, where it holds the pixel's feature scaled by its
    within-class softmax weight.

    With a `DispShard` (parallel/sharding.py), x is this rank's planes
    [lo, hi) of D and `logits` the whole D on every rank: each rank takes
    the same softmax, argmax and class statistics, and returns its planes.
    A pixel's output is non-zero only at its argmax plane, and the rank
    that holds that plane holds the pixel's feature there, so nothing is
    exchanged."""
    b, c, planes, h, w = x.shape
    d = logits.shape[1] if logits.dim() == 4 else -1
    lo, hi = (0, d) if shard is None else shard.span(d)
    if logits.shape != (b, d, h, w) or hi - lo != planes:
        raise ValueError(f"logits {tuple(logits.shape)} do not fit volume {tuple(x.shape)}")

    p = logits.softmax(dim=1)
    a = p.argmax(dim=1)  # (B, H, W), first maximum on ties, as jnp.argmax
    s = p.amax(dim=1)  # (B, H, W)
    onehot = F.one_hot(a, d).to(p.dtype)  # (B, H, W, D)

    # Sentinel for empty classes is 0.0: s is a softmax maximum, so s >= 1/D > 0
    # for every pixel, and the masked max over a NON-empty class is unaffected;
    # empty classes are never gathered back. (A -inf sentinel poisons the
    # one-hot contraction with 0 * inf = NaN, and a -1e30 sentinel has been
    # seen to overflow to inf once exp(s - pix_max) is factored.)
    masked_s = torch.where(onehot > 0, s[..., None], 0.0)
    class_max = masked_s.amax(dim=(1, 2))  # (B, D)
    pix_max = (onehot * class_max[:, None, None, :]).sum(dim=-1)  # (B, H, W)

    e = torch.exp(s - pix_max)
    class_sum = (onehot * e[..., None]).sum(dim=(1, 2))  # (B, D)
    pix_sum = (onehot * class_sum[:, None, None, :]).sum(dim=-1)
    weight = e / pix_sum  # (B, H, W)

    mask = onehot[..., lo:hi].permute(0, 3, 1, 2)[:, None]  # (B, 1, D, H, W): this rank's planes
    f = (x * mask.to(x.dtype)).sum(dim=2)  # (B, C, H, W): feature at the argmax plane (0 off this rank)
    scaled = (f.to(weight.dtype) * weight[:, None]).to(x.dtype)
    return mask.to(x.dtype) * scaled[:, :, None]
