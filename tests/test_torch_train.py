"""The port's training path against the JAX package's, on the CPU: the
train forward, its BatchNorm statistics, and the port's own train loop
(overfit, checkpoints, remat). One train step against the JAX train_step is
tests/test_torch_train_step.py.

Weights are drawn once per case on the port's side (reference init, then
BatchNorm affine and running statistics randomised with numpy), carried to
flax through `weights.to_jax_variables` and back through
`weights.from_jax_variables` with strict loading, so both frameworks start
from the same variables. The JAX side runs under jax.jit. Inputs 1x3x32x64,
maxdisp 32.

Tolerances are the JAX package's own train-mode parity against the
reference torch network (tests/test_torch_parity.py:118-120): probability
volumes atol 1e-3, disparities atol 2e-2. Class logits and BatchNorm
statistics: float32 sums in another order through the network, atol 1e-3
after scaling by max(|x|, 1).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from dcanet_tpu.models import DCANet as FlaxDCANet
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.checkpoint import CheckpointManager, load_params_only, save_params_only
from dcanet_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

MAXDISP, H, Wd = 32, 32, 64
LR_SPEC, STEPS_PER_EPOCH = "12,20,24,28:2", 10


def _flat_variables(num_cva, seed):
    model = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=num_cva), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    flat = W.to_jax_variables(model.state_dict(), num_cva)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("/bias"):
            flat[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    return flat


def _port_model(flat, num_cva, **kw):
    model = DCANet(maxdisp=MAXDISP, num_cva=num_cva, **kw)
    model.load_state_dict(W.from_jax_variables(flat, num_cva), strict=True)
    return model.train()


def _pair(seed):
    rng = np.random.default_rng(seed)
    left = rng.standard_normal((1, H, Wd, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, Wd, 3)).astype(np.float32)
    disp = rng.uniform(1.0, MAXDISP - 2.0, (1, H, Wd)).astype(np.float32)
    return left, right, disp


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _scaled_close(got, want, atol):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


FORWARD_CASES = {  # name: (num_cva, full_res_supervision, ladder lengths (probs, disparities, logits))
    "num_cva0": (0, False, (1, 1, 0)),
    "num_cva1": (1, False, (1, 2, 1)),
    "num_cva3": (3, False, (5, 2, 3)),
    "num_cva1_full_res": (1, True, (0, 3, 1)),
}


@pytest.fixture(scope="module")
def forward_outputs():
    """Per case: (flax train output, flax updated batch_stats, port output, port model)."""
    left, right, _ = _pair(0)
    results = {}
    for name, (num_cva, full_res, _) in FORWARD_CASES.items():
        flat = _flat_variables(num_cva, seed=1 + num_cva)
        fmodel = FlaxDCANet(maxdisp=MAXDISP, num_cva=num_cva, full_res_supervision=full_res)
        apply = jax.jit(lambda v, l, r: fmodel.apply(v, l, r, train=True, mutable=["batch_stats"]))
        fout, upd = apply(unflatten_dict(flat, sep="/"), jnp.asarray(left), jnp.asarray(right))
        model = _port_model(flat, num_cva, full_res_supervision=full_res)
        with torch.no_grad():
            tout = model(_nchw(left), _nchw(right))
        results[name] = (fout, upd["batch_stats"], tout, model)
    return results


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_train_forward_matches_flax(forward_outputs, case):
    fout, _, tout, _ = forward_outputs[case]
    n_prob, n_disp, n_logits = FORWARD_CASES[case][2]
    assert (len(tout.prob_volumes), len(tout.disparities), len(tout.class_logits)) == (n_prob, n_disp, n_logits)
    assert (len(fout.prob_volumes), len(fout.disparities), len(fout.class_logits)) == (n_prob, n_disp, n_logits)
    for got, want in zip(tout.prob_volumes, fout.prob_volumes):
        assert got.shape == (1, MAXDISP // 4, H // 4, Wd // 4) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    for got, want in zip(tout.disparities, fout.disparities):
        assert got.shape == (1, H, Wd) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)
    for got, want in zip(tout.class_logits, fout.class_logits):
        _scaled_close(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_train_forward_bn_statistics_match_flax(forward_outputs, case):
    """The running statistics after one train forward (stacked left+right
    batch statistics, flax's biased variance)."""
    _, stats, _, model = forward_outputs[case]
    num_cva = FORWARD_CASES[case][0]
    got = W.to_jax_variables(model.state_dict(), num_cva)
    want = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(stats).items()}
    assert set(want) <= set(got)
    for k, v in want.items():
        _scaled_close(got[k], v, atol=1e-3)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_stacked_features_false_runs_two_extractor_calls():
    """stacked_features=False: BatchNorm statistics per image, as two calls."""
    flat = _flat_variables(1, seed=9)
    left, right, _ = _pair(9)
    fmodel = FlaxDCANet(maxdisp=MAXDISP, num_cva=1, stacked_features=False)
    apply = jax.jit(lambda v, l, r: fmodel.apply(v, l, r, train=True, mutable=["batch_stats"]))
    fout, _ = apply(unflatten_dict(flat, sep="/"), jnp.asarray(left), jnp.asarray(right))
    model = _port_model(flat, 1, stacked_features=False)
    with torch.no_grad():
        tout = model(_nchw(left), _nchw(right))
    for got, want in zip(tout.disparities, fout.disparities):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)
    stacked = _port_model(flat, 1)
    with torch.no_grad():
        other = stacked(_nchw(left), _nchw(right))
    assert not np.allclose(other.disparities[-1].numpy(), tout.disparities[-1].numpy(), atol=1e-3)


def _train_batch(seed, n=1):
    rng = np.random.default_rng(seed)
    return {
        "left": torch.from_numpy(rng.standard_normal((n, 3, H, Wd)).astype(np.float32)),
        "right": torch.from_numpy(rng.standard_normal((n, 3, H, Wd)).astype(np.float32)),
        "disparity": torch.from_numpy(rng.uniform(1.0, MAXDISP - 2.0, (n, H, Wd)).astype(np.float32)),
    }


def test_overfit_one_pair_loss_decreases():
    """The port's train_step fits one pair: the loss falls (in the style of
    tests/test_train_step.py); eval_step gives finite metrics."""
    model = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=1), torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda step: 1e-3)
    batch = _train_batch(0)
    cfg = tloop.LossConfig(max_disp=MAXDISP)
    losses = [float(tloop.train_step(state, batch, cfg)["total"]) for _ in range(10)]
    assert np.isfinite(losses).all(), losses
    assert min(losses[-3:]) < 0.8 * losses[0], losses
    metrics = tloop.eval_step(state, batch, cfg)
    assert set(metrics) == {"epe", "d1", "thres1", "thres2", "thres3"}
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A full checkpoint restores model, BN statistics, optimizer and step:
    the resumed run's next step equals the uninterrupted run's. Params-only
    weights load strictly into a fresh model."""
    cfg = tloop.LossConfig(max_disp=MAXDISP)
    lr_fn = tsched.epoch_decay_schedule(1e-3, "1:2", 2)

    def fresh():
        model = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=1), torch.Generator().manual_seed(1))
        return create_train_state(model, lr_fn)

    state = fresh()
    for i in range(2):
        tloop.train_step(state, _train_batch(10 + i), cfg)
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=1)
    mgr.save(state)
    uninterrupted = float(tloop.train_step(state, _train_batch(12), cfg)["total"])
    mgr.save(state)
    assert mgr.steps() == [3]  # max_to_keep

    resumed = fresh()
    mgr.restore(resumed, step=None)
    assert resumed.step == 3
    for (k, a), b in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    # resume from step 2 and take step 3 again: the same loss
    state2 = fresh()
    for i in range(2):
        tloop.train_step(state2, _train_batch(10 + i), cfg)
    mgr2 = CheckpointManager(tmp_path / "ckpt2")
    mgr2.save(state2)
    again = fresh()
    mgr2.restore(again)
    assert again.step == 2 and again.optimizer.state_dict()["state"]
    assert float(tloop.train_step(again, _train_batch(12), cfg)["total"]) == pytest.approx(uninterrupted, rel=1e-6)

    save_params_only(tmp_path / "weights.pt", state.model)
    loaded = load_params_only(tmp_path / "weights.pt", DCANet(maxdisp=MAXDISP, num_cva=1))
    for (k, a), b in zip(state.model.state_dict().items(), loaded.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_remat_matches_no_remat():
    """remat (torch.utils.checkpoint around each CVA) gives the same loss,
    grads and BatchNorm statistics; the recomputation in the backward does
    not update the statistics a second time."""
    base = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=2), torch.Generator().manual_seed(3))
    batch = _train_batch(3)
    cfg = tloop.LossConfig(max_disp=MAXDISP)
    results = {}
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.remat = remat
        model.train()
        out = model(batch["left"], batch["right"])
        loss, _ = tloop.compute_loss(out, batch["disparity"], tloop.valid_mask(batch["disparity"], MAXDISP), cfg)
        loss.backward()
        results[remat] = (float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()},
                          {k: v.clone() for k, v in model.state_dict().items() if "running" in k or "tracked" in k})
    (l0, g0, s0), (l1, g1, s1) = results[False], results[True]
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=1e-7, msg=k)
    tracked = [v for k, v in s1.items() if k.endswith("num_batches_tracked") and k.startswith("cva")]
    assert tracked and all(int(v) == 1 for v in tracked)
