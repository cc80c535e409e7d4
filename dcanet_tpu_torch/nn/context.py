"""Context and attention modules of the reference's ablation family (port of
dcanet_tpu/nn/context.py). Volumes are (B, C, D, H, W); each module takes
its input channels at construction, and the disparity planes D where a
Linear's width depends on them.

  * NonLocalAttention — one attention head over all D*H*W positions
    (models/augment/NonLocal.py:60-94; its (N, N) similarity grows as N²,
    small inputs only).
  * ImageLevelContext — disparity-axis cross-attention + a 1x1x1 bottleneck
    (models/augment/image_level.py:14-48).
  * DisparityLevelContext — squeeze over (H, W) of the (D*C)-feature view,
    then a sigmoid gate (models/augment/image_level.py:51-92).
  * SELayerD — squeeze-excite over D (semantic_level_local.py:14-38).
  * SemanticLevelContextLocal — mask by the argmax class, 3D conv, mask
    again, cross-attention (semantic_level_local.py:105-117).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from dcanet_tpu_torch.nn.attention import DisparityAttentionBlock, Projection
from dcanet_tpu_torch.nn.layers import ConvBNAct


class NonLocalAttention(nn.Module):
    """Global single-head attention: (B, C, D, H, W) query and key features
    -> (B, out_channels, D, H, W). The scale multiplies the similarity after
    the dot, as the JAX module does."""

    def __init__(self, in_channels: int, transform_channels: int, out_channels: int, matmul_norm: bool = True):
        super().__init__()
        self.scale = transform_channels**-0.5 if matmul_norm else 1.0
        self.query_project = Projection(in_channels, transform_channels, 2)
        self.key_project = Projection(in_channels, transform_channels, 2)
        self.value_project = Projection(in_channels, transform_channels, 1)
        self.out_project = Projection(transform_channels, out_channels, 1)

    def forward(self, query_feats: torch.Tensor, key_feats: torch.Tensor) -> torch.Tensor:
        b, _, d, h, w = query_feats.shape
        q = self.query_project(query_feats).flatten(2)  # (B, T, N)
        k = self.key_project(key_feats).flatten(2)
        v = self.value_project(key_feats).flatten(2)
        sim = torch.einsum("bcq,bck->bqk", q, k) * self.scale
        attn = sim.softmax(dim=-1)
        ctx = torch.einsum("bqk,bck->bcq", attn.to(v.dtype), v)
        return self.out_project(ctx.reshape(b, -1, d, h, w))


class ImageLevelContext(nn.Module):
    """Cross-attention along D of x with itself, then, with `concat_input`,
    [ctx, x] through a 1x1x1 ConvBN + LeakyReLU(0.1).

    The key is x itself: the JAX module concatenates a global-average
    context onto x and slices x's channels back (dcanet_tpu/nn/context.py:74),
    so the pooled context never reaches the attention. The port gives the
    same function and skips the dropped pooling."""

    def __init__(self, in_channels: int, feats_channels: int, transform_channels: int, concat_input: bool = True):
        super().__init__()
        self.cross_attention = DisparityAttentionBlock(in_channels, transform_channels, feats_channels)
        self.bottleneck = None
        if concat_input:
            self.bottleneck = ConvBNAct(feats_channels + in_channels, feats_channels, 1, 1, 0, dims=3,
                                        act=nn.LeakyReLU(0.1, inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = self.cross_attention(x, x)
        if self.bottleneck is not None:
            ctx = self.bottleneck(torch.cat([ctx, x], dim=1))
        return ctx


class DisparityLevelContext(nn.Module):
    """Mean over (H, W) of the (D*C)-feature view, two Linears (ReLU, then a
    sigmoid) and a per-(d, c) gate on x. The features are ordered d-major
    (index d*C + c), as the JAX module flattens its (..., D, C) view."""

    def __init__(self, in_channels: int, disparity_planes: int, reduction: int = 8):
        super().__init__()
        n = disparity_planes * in_channels
        self.fc1 = nn.Linear(n, n // reduction)
        self.fc2 = nn.Linear(n // reduction, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d = x.shape[:3]
        pooled = x.mean(dim=(3, 4)).transpose(1, 2).reshape(b, d * c)  # d-major
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled))))
        return x * gate.view(b, d, c).transpose(1, 2)[..., None, None]


class SELayerD(nn.Module):
    """Squeeze-excite over D: the mean over (C, H, W), two bias-free Linears
    of hidden width max(D // reduction, 1), a sigmoid gate per plane."""

    def __init__(self, disparity_planes: int, reduction: int = 8):
        super().__init__()
        hidden = max(disparity_planes // reduction, 1)
        self.fc1 = nn.Linear(disparity_planes, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, disparity_planes, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=(1, 3, 4))))))
        return x * y[:, None, :, None, None]


class SemanticLevelContextLocal(nn.Module):
    """x (B, C, D, H, W) and class logits (B, D, H, W): the volume masked by
    the one-hot of the argmax class over D, a 3x3x3 ConvBN + ReLU, masked
    again, then DisparityAttentionBlock(x, agg + x)."""

    def __init__(self, in_channels: int, feats_channels: int = 32, transform_channels: int = 32):
        super().__init__()
        self.agg = ConvBNAct(in_channels, in_channels, 3, 1, 1, dims=3)
        self.cross_attention = DisparityAttentionBlock(in_channels, transform_channels, feats_channels)

    def forward(self, x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        d = x.shape[2]
        cls = logits.softmax(dim=1).argmax(dim=1)  # (B, H, W)
        mask = F.one_hot(cls, d).permute(0, 3, 1, 2)[:, None].to(x.dtype)  # (B, 1, D, H, W)
        agg = self.agg(x * mask) * mask
        return self.cross_attention(x, agg + x)
