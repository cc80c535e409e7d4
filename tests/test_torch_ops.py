"""The port's plain ops (dcanet_tpu_torch.ops) against dcanet_tpu.ops.

Same numpy inputs on both sides; the JAX package is channel-last, the port
channel-first, so inputs and outputs are transposed at the boundary. All in
float32 on the CPU: the two sides differ only in summation order, hence the
1e-5 absolute tolerance on O(1) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcanet_tpu.ops import cost_volume as jcv
from dcanet_tpu.ops import regression as jreg
from dcanet_tpu.ops import slc as jslc
from dcanet_tpu.ops import upsample as jup
from dcanet_tpu_torch.ops import (
    build_concat_volume,
    build_gwc_volume,
    convex_upsample,
    disparity_regression,
    resize_trilinear,
    slc_pool,
    unfold3x3,
)

torch.set_num_threads(2)

ATOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _to_channel_last(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("maxdisp", [8, 12, 20])  # 20 > W: all-zero planes
def test_build_gwc_volume(rng, maxdisp):
    b, h, w, c, g = 2, 4, 16, 32, 4
    left = rng.standard_normal((b, h, w, c), dtype=np.float32)
    right = rng.standard_normal((b, h, w, c), dtype=np.float32)
    want = np.asarray(jcv.build_gwc_volume(jnp.asarray(left), jnp.asarray(right), maxdisp, g))
    got = build_gwc_volume(_nchw(left), _nchw(right), maxdisp, g)
    assert got.shape == (b, g, maxdisp, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(_to_channel_last(got), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("maxdisp", [8, 20])
def test_build_concat_volume(rng, maxdisp):
    b, h, w, c = 2, 4, 16, 6
    left = rng.standard_normal((b, h, w, c), dtype=np.float32)
    right = rng.standard_normal((b, h, w, c), dtype=np.float32)
    want = np.asarray(jcv.build_concat_volume(jnp.asarray(left), jnp.asarray(right), maxdisp))
    got = build_concat_volume(_nchw(left), _nchw(right), maxdisp)
    assert got.shape == (b, 2 * c, maxdisp, h, w)
    np.testing.assert_allclose(_to_channel_last(got), want, atol=ATOL, rtol=0)


def test_disparity_regression(rng):
    logits = rng.standard_normal((2, 12, 5, 7)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want = np.asarray(jreg.disparity_regression(jnp.asarray(prob), 12))
    got = disparity_regression(torch.from_numpy(prob), 12).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [2, 4])
def test_resize_trilinear_rank4(rng, scale):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)  # (B, D, H, W)
    want = np.asarray(jup.resize_trilinear(jnp.asarray(x), scale))
    got = resize_trilinear(torch.from_numpy(x), scale).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [2, 4])
def test_resize_trilinear_rank5(rng, scale):
    x = rng.standard_normal((1, 3, 4, 5, 6)).astype(np.float32)  # (B, D, H, W, C)
    want = np.asarray(jup.resize_trilinear(jnp.asarray(x), scale))
    got = resize_trilinear(_nchw(x), scale)
    np.testing.assert_allclose(_to_channel_last(got), want, atol=ATOL, rtol=0)


def test_unfold3x3(rng):
    x = rng.standard_normal((2, 5, 7)).astype(np.float32)
    want = np.asarray(jup.unfold3x3(jnp.asarray(x)))  # (B, H, W, 9)
    got = unfold3x3(torch.from_numpy(x))  # (B, 9, H, W)
    np.testing.assert_array_equal(_to_channel_last(got), want)


@pytest.mark.parametrize("scale", [2, 4])
def test_convex_upsample(rng, scale):
    b, h, w = 2, 5, 6
    disp = rng.uniform(0, 10, (b, h, w)).astype(np.float32)
    mask = rng.standard_normal((b, h, w, 9 * scale * scale)).astype(np.float32)
    want = np.asarray(jup.convex_upsample(jnp.asarray(disp), jnp.asarray(mask), scale))
    got = convex_upsample(torch.from_numpy(disp), _nchw(mask), scale).numpy()
    assert got.shape == (b, h * scale, w * scale)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("empty_classes", [False, True])
def test_slc_pool(rng, empty_classes):
    b, d, h, w, c = 2, 6, 5, 7, 4
    x = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    logits = rng.standard_normal((b, d, h, w)).astype(np.float32)
    if empty_classes:
        # every pixel's argmax falls on plane 1 or 2: classes 0, 3, 4, 5 are empty
        logits[:, 1:3] += 10.0
    want = np.asarray(jslc.slc_pool(jnp.asarray(x), jnp.asarray(logits)))
    got = slc_pool(_nchw(x), torch.from_numpy(logits))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(_to_channel_last(got), want, atol=ATOL, rtol=0)
    if empty_classes:
        assert not got[:, :, [0, 3, 4, 5]].any()
