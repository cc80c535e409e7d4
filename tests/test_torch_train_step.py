"""One train step of the port against the JAX package's train_step, on the CPU.

Both start from the same variables (drawn as in tests/test_torch_train.py)
and take one Adam step on one 1x3x32x64 pair, maxdisp 32, num_cva=1; the
JAX side runs its own jitted train_step. Tolerances: loss terms rtol 1e-4,
grad norm rtol 1e-3 (float32 sums in another order through forward and
backward), epe atol 2e-2 (a disparity, as the JAX package's train parity);
BatchNorm statistics atol 1e-3 after scaling by max(|x|, 1); parameters as
stated in the last test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from dcanet_tpu.models import DCANet as FlaxDCANet
from dcanet_tpu.train import loop as jloop
from dcanet_tpu.train import schedule as jsched
from dcanet_tpu.train.state import TrainState as FlaxTrainState
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_train import LR_SPEC, MAXDISP, STEPS_PER_EPOCH, _flat_variables, _flatten, _nchw, _pair, _port_model, _scaled_close

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def one_step():
    """One train step from the same weights in both frameworks, num_cva=1."""
    num_cva = 1
    flat = _flat_variables(num_cva, seed=5)
    left, right, disp = _pair(5)
    variables = unflatten_dict(flat, sep="/")
    fmodel = FlaxDCANet(maxdisp=MAXDISP, num_cva=num_cva)
    tx = jsched.make_adam(jsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    params = jax.tree.map(jnp.asarray, variables["params"])
    fstate = FlaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), apply_fn=fmodel.apply, tx=tx,
    )
    batch = {"left": jnp.asarray(left), "right": jnp.asarray(right), "disparity": jnp.asarray(disp)}
    new_fstate, fmetrics = jloop.train_step(fstate, batch, jloop.LossConfig(max_disp=MAXDISP))

    model = _port_model(flat, num_cva)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    tbatch = {"left": _nchw(left), "right": _nchw(right), "disparity": torch.from_numpy(disp)}
    tmetrics = tloop.train_step(state, tbatch, tloop.LossConfig(max_disp=MAXDISP))
    fvars = {"params": new_fstate.params, "batch_stats": new_fstate.batch_stats}
    return fmetrics, fvars, tmetrics, state, before, flat


@pytest.mark.parametrize("key", ["total", "focal", "smooth_l1", "grad_norm", "epe"])
def test_train_step_metrics_match_jax(one_step, key):
    fmetrics, _, tmetrics, state, _, _ = one_step
    assert state.step == 1
    got, want = float(tmetrics[key]), float(fmetrics[key])
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    else:
        assert got == pytest.approx(want, rel=1e-3 if key == "grad_norm" else 1e-4)


def test_train_step_bn_statistics_match_jax(one_step):
    _, fvars, _, state, _, _ = one_step
    got = W.to_jax_variables(state.model.state_dict(), 1)
    want = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(fvars["batch_stats"]).items()}
    for k, v in want.items():
        _scaled_close(got[k], v, atol=1e-3)


def test_train_step_parameters_match_jax(one_step):
    """Adam's first step moves a parameter by lr * g / (|g| + eps): by -+lr
    wherever |g| >> eps. Where a step is within 0.1 % of +-lr in both
    frameworks (|g| above ~1e-5) the two steps agree to 1e-5;
    elements whose step is off +-lr or differs in sign (gradients within
    rounding of 0) stay under 1 %, and no step exceeds lr."""
    _, fvars, _, state, before, flat = one_step
    lr = 1e-3
    got = W.to_jax_variables(state.model.state_dict(), 1)
    start = W.to_jax_variables(before, 1)
    want = {f"params/{k}": np.asarray(v) for k, v in _flatten(fvars["params"]).items()}
    assert set(want) == {k for k in flat if k.startswith("params/")}
    loose = total = 0
    for k, v in want.items():
        d_got, d_want = got[k] - start[k], v - start[k]
        firm = (np.sign(d_got) == np.sign(d_want)) & (np.minimum(np.abs(d_got), np.abs(d_want)) > 0.999 * lr)
        np.testing.assert_allclose(d_got[firm], d_want[firm], atol=1e-5, rtol=0, err_msg=k)
        assert np.abs(d_got).max() <= 1.01 * lr, k
        loose += int((~firm).sum())
        total += v.size
    assert loose <= 0.01 * total, (loose, total)


