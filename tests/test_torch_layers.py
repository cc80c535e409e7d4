"""Eval-mode blocks of the port (dcanet_tpu_torch.nn) against their flax twins.

Each flax block is initialised, its BatchNorm affine parameters, running
statistics and conv biases are randomised with numpy, and the same variables
are carried into the port's block through the port's key table
(dcanet_tpu_torch.weights) and loaded with strict=True. Both run the same
numpy input in float32 on the CPU. Outputs are compared after scaling by
max(|reference|, 1), at 1e-4: float32 convolutions summed in another order,
through up to 50 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dcanet_tpu.nn import aggregation as jagg
from dcanet_tpu.nn import attention as jatt
from dcanet_tpu.nn import cva as jcva
from dcanet_tpu.nn import feature as jfeat
from dcanet_tpu.nn import guidance as jguid
from dcanet_tpu.nn import layers as jlayers
from dcanet_tpu.nn import propagation as jprop
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.nn.aggregation import MultiAggregation
from dcanet_tpu_torch.nn.attention import DisparityAttentionBlock
from dcanet_tpu_torch.nn.cva import CVA
from dcanet_tpu_torch.nn.feature import FeatureExtractor
from dcanet_tpu_torch.nn.guidance import Guidance
from dcanet_tpu_torch.nn.layers import BasicBlock, ResidualBlock
from dcanet_tpu_torch.nn.propagation import PropagationNet

torch.set_num_threads(2)


def randomize(variables, seed):
    """Flat numpy copy of flax variables with random BN affine/statistics and
    conv biases (fresh BN is an identity that would hide layout faults)."""
    rng = np.random.default_rng(seed)
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables, sep="/").items()}
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0.0, 0.2, v.shape)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/bias"):
            flat[k] = rng.normal(0.0, 0.1, v.shape)
        flat[k] = flat[k].astype(np.float32)
    return flat


def port_block(block, flat, table):
    block.load_state_dict(W.state_dict_from_flax(flat, table), strict=True)
    return block.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def assert_scaled_close(got, want, atol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def run_pair(fmod, fargs, tmod, targs, table, seed=1):
    """flax apply (eval) and port forward on the same variables."""
    variables = fmod.init(jax.random.PRNGKey(0), *fargs, train=False)
    flat = randomize(variables, seed)
    fout = fmod.apply(unflatten_dict(flat, sep="/"), *fargs, train=False)
    with torch.no_grad():
        tout = port_block(tmod, flat, table)(*targs)
    return fout, tout


@pytest.mark.parametrize(
    "in_planes,planes,stride,dilation",
    [(16, 16, 1, 1), (16, 32, 2, 1), (32, 32, 1, 2)],
)
def test_basic_block(rng, in_planes, planes, stride, dilation):
    x = rng.standard_normal((1, 12, 16, in_planes)).astype(np.float32)
    down = stride != 1 or in_planes != planes
    fout, tout = run_pair(
        jlayers.BasicBlock(planes, strides=stride, dilation=dilation), (jnp.asarray(x),),
        BasicBlock(in_planes, planes, stride, dilation), (nchw(x),),
        W.basic_block_table("", "", down),
    )
    assert_scaled_close(np.moveaxis(tout.numpy(), 1, -1), fout)


@pytest.mark.parametrize("in_planes,planes,stride", [(16, 16, 1), (16, 32, 2)])
def test_residual_block(rng, in_planes, planes, stride):
    x = rng.standard_normal((1, 12, 16, in_planes)).astype(np.float32)
    fout, tout = run_pair(
        jlayers.ResidualBlock(planes, strides=stride), (jnp.asarray(x),),
        ResidualBlock(in_planes, planes, stride), (nchw(x),),
        W.residual_block_table("", "", stride != 1),
    )
    assert_scaled_close(np.moveaxis(tout.numpy(), 1, -1), fout)


def test_feature_extractor(rng):
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    fout, tout = run_pair(
        jfeat.FeatureExtractor(), (jnp.asarray(x),),
        FeatureExtractor(), (nchw(x),),
        W.feature_extraction_table("", ""),
    )
    for key in ("gwc_feature", "concat_feature"):
        assert_scaled_close(np.moveaxis(tout[key].numpy(), 1, -1), fout[key])


def test_guidance(rng):
    x = rng.standard_normal((1, 32, 64, 3)).astype(np.float32)
    fout, tout = run_pair(
        jguid.Guidance(64), (jnp.asarray(x),), Guidance(64), (nchw(x),), W.guidance_table("", "")
    )
    assert_scaled_close(np.moveaxis(tout.numpy(), 1, -1), fout["g"])


def test_propagation_net(rng):
    g = rng.standard_normal((1, 8, 16, 64)).astype(np.float32)
    disp = rng.uniform(0, 12, (1, 8, 16)).astype(np.float32)
    fout, tout = run_pair(
        jprop.PropagationNet(64, scale=4), (jnp.asarray(g), jnp.asarray(disp)),
        PropagationNet(64, 4), (nchw(g), torch.from_numpy(disp)),
        W.propagation_table("", ""),
    )
    assert tout.shape == (1, 32, 64)
    assert_scaled_close(tout.numpy(), fout)


def test_disparity_attention_block(rng):
    q = rng.standard_normal((1, 6, 4, 5, 16)).astype(np.float32)
    k = rng.standard_normal((1, 6, 4, 5, 16)).astype(np.float32)
    fout, tout = run_pair(
        jatt.DisparityAttentionBlock(transform_channels=16, out_channels=16),
        (jnp.asarray(q), jnp.asarray(k)),
        DisparityAttentionBlock(16, 16, 16), (nchw(q), nchw(k)),
        W.attention_table("", ""),
    )
    assert_scaled_close(np.moveaxis(tout.numpy(), 1, -1), fout)


@pytest.mark.parametrize("with_residual", [False, True])
def test_multi_aggregation(rng, with_residual):
    x = rng.standard_normal((1, 4, 6, 8, 8)).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32) if with_residual else None
    fmod = jagg.MultiAggregation(8)
    variables = fmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    flat = randomize(variables, 2)
    fout = fmod.apply(
        unflatten_dict(flat, sep="/"), jnp.asarray(x), train=False,
        post_residual=None if res is None else jnp.asarray(res),
    )
    tmod = port_block(MultiAggregation(8), flat, W.multi_aggregation_table("", ""))
    with torch.no_grad():
        tout = tmod(nchw(x), None if res is None else nchw(res))
    assert_scaled_close(np.moveaxis(tout.numpy(), 1, -1), fout)


@pytest.mark.parametrize("with_residual", [False, True])
def test_cva(rng, with_residual):
    x = rng.standard_normal((1, 8, 8, 12, 16)).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32) if with_residual else None
    fmod = jcva.CVA(16)
    variables = fmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    flat = randomize(variables, 3)
    flogits, fagg = fmod.apply(
        unflatten_dict(flat, sep="/"), jnp.asarray(x), train=False,
        post_residual=None if res is None else jnp.asarray(res),
    )
    tmod = port_block(CVA(16), flat, W.cva_table("", ""))
    with torch.no_grad():
        tlogits, tagg = tmod(nchw(x), None if res is None else nchw(res))
    assert tlogits.shape == (1, 4, 4, 6)
    assert_scaled_close(tlogits.numpy(), flogits)
    assert_scaled_close(np.moveaxis(tagg.numpy(), 1, -1), fagg)
