"""Disparity-axis multi-head cross-attention (port of dcanet_tpu/nn/attention.py).

Reference SelfAttentionBlock (models/augment/SelfAttention_bn.py:62-98):
per-pixel attention over D, heads of head_dim 8 carved from contiguous
channel blocks, 1x1x1 conv+BN+LeakyReLU(0.1) projections, softmax over the
key-disparity axis. Volumes are (B, C, D, H, W).
"""

from __future__ import annotations

import torch
from torch import nn

from dcanet_tpu_torch.nn.layers import ConvBNSequential, batch_norm
from dcanet_tpu_torch.ops.precision import in_model_dtype


class Projection(ConvBNSequential):
    """`buildproject` (SelfAttention_bn.py:136-160), normed flavour:
    num_convs of [1x1x1 conv (no bias) -> BN -> LeakyReLU(0.1)], each BN
    folded into its conv in a bf16 eval as in the JAX Projection. With one
    conv the Sequential holds (conv, bn, act) itself, as the reference nests
    it."""

    def __init__(self, in_channels: int, features: int, num_convs: int = 1):
        blocks = [
            ConvBNSequential(
                nn.Conv3d(in_channels if i == 0 else features, features, 1, bias=False),
                batch_norm(features, 3),
                nn.LeakyReLU(0.1, inplace=True),
            )
            for i in range(num_convs)
        ]
        super().__init__(*(blocks[0] if num_convs == 1 else blocks))


class DisparityAttentionBlock(nn.Module):
    """Cross-attention along the disparity axis, per pixel.

    query_feats, key_feats: (B, C, D, H, W) -> (B, out_channels, D, H, W).
    With a `DispShard` (parallel/sharding.py) both are this rank's planes
    of a D-sharded volume: the queries stay on them, and the keys and values
    cover every plane. The key features are gathered (one exchange of C
    channels) and every rank projects them whole; gathering the projected K
    and V instead would move twice the bytes to save three pointwise convs.
    """

    def __init__(
        self, in_channels: int, transform_channels: int, out_channels: int,
        key_query_num_convs: int = 2, value_out_num_convs: int = 1, head_dim: int = 8,
    ):
        super().__init__()
        if transform_channels % head_dim:
            raise ValueError(f"transform_channels {transform_channels} not a multiple of head_dim {head_dim}")
        self.head_dim = head_dim
        self.query_project = Projection(in_channels, transform_channels, key_query_num_convs)
        self.key_project = Projection(in_channels, transform_channels, key_query_num_convs)
        self.value_project = Projection(in_channels, transform_channels, value_out_num_convs)
        self.out_project = Projection(transform_channels, out_channels, value_out_num_convs)

    def forward(self, query_feats: torch.Tensor, key_feats: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is not None:
            key_feats = shard.gather(key_feats, 2)
        b, _, d, h, w = query_feats.shape
        dk = key_feats.shape[2]
        hd = self.head_dim
        # The query is scaled BEFORE the dot, as the JAX package does: the
        # product stays finite at magnitudes where softmax(sim * scale) would not.
        query = self.query_project(query_feats) * hd**-0.5
        key = self.key_project(key_feats)
        value = self.value_project(key_feats)
        tc = query.shape[1]
        # channel = head * head_dim + e: contiguous head blocks
        q = query.view(b, tc // hd, hd, d, h, w)
        k = key.view(b, tc // hd, hd, dk, h, w)
        v = value.view(b, tc // hd, hd, dk, h, w)
        sim = torch.einsum("bneihw,bnejhw->bnhwij", q, k)
        # over the key disparity j, in the model's dtype (ops/precision.py)
        attn = in_model_dtype(lambda s: s.softmax(dim=-1), sim)
        ctx = torch.einsum("bnhwij,bnejhw->bneihw", attn.to(v.dtype), v)
        return self.out_project(ctx.reshape(b, tc, d, h, w))
