"""The whole slice: the port's DCANet(num_cva=3) eval forward against flax.

flax DCANet(maxdisp=64, num_cva=3) is initialised with train=True, so that
classif0..classif2 exist, its BatchNorm statistics and affine parameters and
conv biases are randomised with numpy, and the variables go into the port
through `weights.from_jax_variables` with strict loading. Tolerances are the
JAX package's own eval parity against the reference torch network
(tests/test_torch_parity.py): disparity atol 5e-3 px, class logits atol 1e-4
after scaling by max(|logits|, 1).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dcanet_tpu.models import DCANet as FlaxDCANet
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.kernels import gwc
from dcanet_tpu_torch.models import DCANet, DCANetEvalOutput, DCANetTrainOutput
from tools.convert_torch_ckpt import export_state_dict

torch.set_num_threads(2)

MAXDISP, NUM_CVA = 64, 3
H, Wd = 64, 128


def _randomize(flat, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("/mean"):
            v = rng.normal(0.0, 0.2, v.shape)
        elif k.endswith("/var") or k.endswith("/scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/bias"):
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(flat flax variables, flax eval output, port model, port eval output)."""
    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, H, Wd, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, Wd, 3)).astype(np.float32)
    fmodel = FlaxDCANet(maxdisp=MAXDISP, num_cva=NUM_CVA)
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(left), jnp.asarray(right), train=True)
    flat = _randomize(flatten_dict(variables, sep="/"), seed=1)
    fout = fmodel.apply(unflatten_dict(flat, sep="/"), jnp.asarray(left), jnp.asarray(right), train=False)

    model = DCANet(maxdisp=MAXDISP, num_cva=NUM_CVA)
    model.load_state_dict(W.from_jax_variables(flat, NUM_CVA), strict=True)
    model.eval()
    tl = torch.from_numpy(left.transpose(0, 3, 1, 2).copy())
    tr = torch.from_numpy(right.transpose(0, 3, 1, 2).copy())
    launches = gwc.LAUNCHES
    with torch.no_grad():
        tout = model(tl, tr)
    assert gwc.LAUNCHES == launches  # CPU tensors take the plain gwc version
    return flat, fout, model, tout


def test_state_dict_matches_export_state_dict(pair):
    """The port's copied key table against tools/convert_torch_ckpt, key for
    key and value for value."""
    flat, _, model, _ = pair
    want = export_state_dict(unflatten_dict(flat, sep="/"), NUM_CVA)
    got = W.from_jax_variables(flat, NUM_CVA)
    model_keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want) == model_keys
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_to_jax_variables_roundtrip(pair):
    flat, _, model, _ = pair
    back = W.to_jax_variables(model.state_dict(), NUM_CVA)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_eval_disparity_matches_flax(pair):
    _, fout, _, tout = pair
    assert tout.disparity.shape == (1, H, Wd) and tout.disparity.dtype == torch.float32
    np.testing.assert_allclose(tout.disparity.numpy(), np.asarray(fout.disparity), atol=5e-3, rtol=0)


@pytest.mark.parametrize("level", range(NUM_CVA))
def test_eval_class_logits_match_flax(pair, level):
    _, fout, _, tout = pair
    want = np.asarray(fout.class_logits[level])
    got = tout.class_logits[level].numpy()
    assert got.shape == want.shape == (1, MAXDISP // 8, H // 8, Wd // 8)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4, rtol=0)


def test_train_mode_is_refused(pair):
    """Train mode refuses the eval contract: since the training slice it runs
    the train forward (the supervision ladders of DCANetTrainOutput), and the
    eval output comes only from eval mode. A copy, since a train forward
    updates the BatchNorm running statistics."""
    model = copy.deepcopy(pair[2]).train()
    x = torch.zeros(1, 3, H, Wd)
    with torch.no_grad():
        out = model(x, x)
    assert not isinstance(out, DCANetEvalOutput)
    assert isinstance(out, DCANetTrainOutput)
    assert (len(out.prob_volumes), len(out.disparities), len(out.class_logits)) == (5, 2, NUM_CVA)
