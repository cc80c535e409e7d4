"""Train-mode BatchNorm of the port (dcanet_tpu_torch.nn.layers.batch_norm)
against flax's nn.BatchNorm(use_running_average=False), the JAX package's
`nn.layers.BatchNorm` (momentum 0.9, eps 1e-5).

flax normalises with the biased batch variance and updates the running
variance with that same biased variance; torch's own BatchNorm updates it
with the unbiased one (x N/(N-1)). The port must follow flax. Outputs and
updated statistics are compared at atol 1e-5 (float32, the same formulas
summed in another order); a batch of two elements per channel makes the two
variances differ by 2x, so the trap is visible.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from dcanet_tpu.nn.layers import BatchNorm as FlaxBatchNorm
from dcanet_tpu_torch.nn.layers import batch_norm, frozen_bn_statistics

torch.set_num_threads(2)

CASES = {  # name: NC... shape
    "2d": (2, 5, 3, 4),
    "3d": (1, 4, 2, 3, 5),
    "2d_two_per_channel": (2, 3, 1, 1),
    "2d_one_per_channel": (1, 3, 1, 1),  # torch's F.batch_norm refuses it; flax gives the bias
}


def _flax_train(x_nc, scale, bias, mean, var):
    """flax BN in train mode on the channel-last input; returns (y NC..., new mean, new var)."""
    x = jnp.asarray(np.moveaxis(x_nc, 1, -1))
    bn = FlaxBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), x, True)
    flat = flatten_dict(variables, sep="/")
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    stats = {"BatchNorm_0": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    assert {k.split("/")[-1] for k in flat} == {"scale", "bias", "mean", "var"}
    y, upd = bn.apply({"params": params, "batch_stats": stats}, x, True, mutable=["batch_stats"])
    s = upd["batch_stats"]["BatchNorm_0"]
    return np.moveaxis(np.asarray(y), -1, 1), np.asarray(s["mean"]), np.asarray(s["var"])


def _port(x_nc, scale, bias, mean, var):
    bn = batch_norm(x_nc.shape[1], x_nc.ndim - 2)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return bn.train()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c).astype(np.float32)
    mean = rng.normal(0.0, 0.2, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, scale, bias, mean, var


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_bn_matches_flax(case):
    x, scale, bias, mean, var = _inputs(CASES[case], seed=len(case))
    want_y, want_mean, want_var = _flax_train(x, scale, bias, mean, var)
    bn = _port(x, scale, bias, mean, var)
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, atol=1e-5, rtol=0)
    assert int(bn.num_batches_tracked) == 1


def test_torch_batchnorm_would_differ():
    """The trap itself: torch's nn.BatchNorm2d updates the running variance
    with the unbiased variance, visibly off flax's with two elements."""
    x, scale, bias, mean, var = _inputs(CASES["2d_two_per_channel"], seed=3)
    _, _, want_var = _flax_train(x, scale, bias, mean, var)
    plain = torch.nn.BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        plain.running_var.copy_(torch.from_numpy(var))
    plain(torch.from_numpy(x))
    assert np.abs(plain.running_var.numpy() - want_var).max() > 1e-2


def test_train_bn_grads_match_flax():
    """Gradients through train-mode BN (batch statistics in the graph)."""
    x, scale, bias, mean, var = _inputs(CASES["3d"], seed=7)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def loss(xc, sc, bi):
        bn = FlaxBatchNorm()
        y, _ = bn.apply(
            {"params": {"BatchNorm_0": {"scale": sc, "bias": bi}},
             "batch_stats": {"BatchNorm_0": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}},
            jnp.moveaxis(xc, 1, -1), True, mutable=["batch_stats"],
        )
        return jnp.sum(jnp.moveaxis(y, -1, 1) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    bn = _port(x, scale, bias, mean, var)
    xt = torch.from_numpy(x).requires_grad_()
    (bn(xt) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((xt.grad, bn.weight.grad, bn.bias.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_frozen_statistics_and_eval_mode():
    """Inside frozen_bn_statistics the batch still normalises but the running
    statistics stay; eval mode normalises with the running statistics."""
    x, scale, bias, mean, var = _inputs(CASES["2d"], seed=11)
    bn = _port(x, scale, bias, mean, var)
    xt = torch.from_numpy(x)
    y_train = bn(xt)
    stats = [t.clone() for t in (bn.running_mean, bn.running_var, bn.num_batches_tracked)]
    with frozen_bn_statistics():
        torch.testing.assert_close(bn(xt), y_train, rtol=0, atol=0)
    for before, after in zip(stats, (bn.running_mean, bn.running_var, bn.num_batches_tracked)):
        torch.testing.assert_close(after, before, rtol=0, atol=0)
    bn.eval()
    want = (x - bn.running_mean.numpy()[:, None, None]) / np.sqrt(bn.running_var.numpy()[:, None, None] + 1e-5)
    want = want * scale[:, None, None] + bias[:, None, None]
    np.testing.assert_allclose(bn(xt).detach().numpy(), want, atol=1e-5, rtol=0)
