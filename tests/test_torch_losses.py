"""Losses, gt probability volumes, metrics, loss presets and LR schedules of
the port against the JAX package, on the same numpy inputs.

Tolerances: float32 elementwise maths and sums in another order, atol 1e-5
relative to the value's scale (rtol 1e-5); the focal loss raises
(1 - p)^-5 and sums over D, so rtol 1e-4. LR schedules must be equal.
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcanet_tpu import losses as jl
from dcanet_tpu.ops import disp2prob as jd
from dcanet_tpu.train import loop as jloop
from dcanet_tpu.train import metrics as jm
from dcanet_tpu.train import schedule as js
from dcanet_tpu_torch import losses as tl
from dcanet_tpu_torch.ops import disp2prob as td
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import metrics as tm
from dcanet_tpu_torch.train import schedule as ts

torch.set_num_threads(2)

B, H, W, MAXDISP = 2, 16, 32, 32


def _gt(rng, sparse=False):
    gt = rng.uniform(-2.0, MAXDISP + 4.0, (B, H, W)).astype(np.float32)
    if sparse:
        gt[:, ::2] = 0.0
    return gt


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["laplace", "gaussian", "onehot"])
@pytest.mark.parametrize("start_disp", [0, 3])
def test_disp2prob_matches_jax(rng, name, start_disp):
    gt = _gt(rng)
    kw = {} if name == "onehot" else {"variance": 1.0 if name == "laplace" else 2.0}
    got = getattr(td, f"{name}_disp2prob")(torch.from_numpy(gt), 24, start_disp=start_disp, **kw)
    want = getattr(jd, f"{name}_disp2prob")(jnp.asarray(gt), 24, start_disp=start_disp, **kw)
    assert got.shape == (B, 24, H, W)
    _close(got, want, atol=1e-7)


def test_laplace_variance_divides_when_not_one(rng):
    gt = _gt(rng)
    _close(td.laplace_disp2prob(torch.from_numpy(gt), 24, variance=0.5),
           jd.laplace_disp2prob(jnp.asarray(gt), 24, variance=0.5), atol=1e-7)


def test_smooth_l1_family_matches_jax(rng):
    pred, gt = rng.uniform(0, 40, (2, B, H, W)).astype(np.float32)
    mask = (gt > 5) & (gt < 30)
    tp, tg, tmask = (torch.from_numpy(a) for a in (pred, gt, mask))
    _close(tl.smooth_l1(tp, tg), jl.smooth_l1(jnp.asarray(pred), jnp.asarray(gt)))
    _close(tl.smooth_l1(tp, tg, beta=2.0), jl.smooth_l1(jnp.asarray(pred), jnp.asarray(gt), beta=2.0))
    _close(tl.masked_smooth_l1(tp, tg, tmask), jl.masked_smooth_l1(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)))
    # an empty mask gives 0, not NaN (denominator clamped at 1)
    empty = np.zeros_like(mask)
    _close(tl.masked_smooth_l1(tp, tg, torch.from_numpy(empty)), 0.0)
    for n in (2, 3, 5):
        ests = rng.uniform(0, 40, (n, B, H, W)).astype(np.float32)
        _close(tl.model_loss(list(torch.from_numpy(ests)), tg, tmask),
               jl.model_loss(list(jnp.asarray(ests)), jnp.asarray(gt), jnp.asarray(mask)))
    with pytest.raises(ValueError):
        tl.model_loss([tp, tp], tg, tmask, weights=(1.0,))


def test_smoothness_loss_matches_jax(rng):
    disp = rng.uniform(0, 40, (B, H, W)).astype(np.float32)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    got = tl.smoothness_loss(torch.from_numpy(disp), torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    _close(got, jl.smoothness_loss(jnp.asarray(disp), jnp.asarray(img)))


@pytest.mark.parametrize("sparse", [False, True])
def test_downsample_gt_matches_jax(rng, sparse):
    gt = _gt(rng, sparse)
    _close(tl._downsample_gt(torch.from_numpy(gt), 4, sparse), jl._downsample_gt(jnp.asarray(gt), 4, sparse))


@pytest.mark.parametrize("scale", [1, 4])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("softmaxed", [False, True])
def test_stereo_focal_loss_matches_jax(rng, scale, sparse, softmaxed):
    """At full and 1/4 resolution, dense and sparse gt, and on an already
    softmaxed volume (the model's ladder, fed to log_softmax again)."""
    gt = _gt(rng, sparse)
    d = MAXDISP // scale
    vol = rng.standard_normal((B, d, H // scale, W // scale)).astype(np.float32) * 3.0
    if softmaxed:
        vol = np.asarray(torch.from_numpy(vol).softmax(1))
    got = tl.stereo_focal_loss(torch.from_numpy(vol), torch.from_numpy(gt), MAXDISP, sparse=sparse)
    want = jl.stereo_focal_loss(jnp.asarray(vol), jnp.asarray(gt), MAXDISP, sparse=sparse)
    _close(got, want, rtol=1e-4)


def test_focal_loss_ladder_matches_jax(rng):
    gt = _gt(rng)
    vols = [rng.standard_normal((B, MAXDISP // 4, H // 4, W // 4)).astype(np.float32) for _ in range(5)]
    got = tl.focal_loss_ladder([torch.from_numpy(v) for v in vols], torch.from_numpy(gt), MAXDISP)
    want = jl.focal_loss_ladder([jnp.asarray(v) for v in vols], jnp.asarray(gt), MAXDISP)
    _close(got, want, rtol=1e-4)


def test_metrics_match_jax(rng):
    est = rng.uniform(0, 40, (B, H, W)).astype(np.float32)
    gt = _gt(rng, sparse=True)
    mask = (gt > 0) & (gt < MAXDISP)
    args_t = [torch.from_numpy(a) for a in (est, gt, mask)]
    args_j = [jnp.asarray(a) for a in (est, gt, mask)]
    got, want = tm.eval_metrics(*args_t), jm.eval_metrics(*args_j)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    _close(tm.thres_metric(*args_t, 0.5), jm.thres_metric(*args_j, 0.5))


Out = namedtuple("Out", "prob_volumes disparities class_logits")


@pytest.mark.parametrize("preset", ["sceneflow", "kitti", "smooth_l1"])
def test_compute_loss_presets_match_jax(rng, preset):
    gt = _gt(rng, sparse=preset == "kitti")
    vols = [np.asarray(torch.from_numpy(rng.standard_normal((B, MAXDISP // 4, H // 4, W // 4)).astype(np.float32))
                       .softmax(1)) for _ in range(5)]
    disps = [rng.uniform(0, 40, (B, H, W)).astype(np.float32) for _ in range(2)]
    cfg_t = tloop.LossConfig(max_disp=MAXDISP, preset=preset)
    cfg_j = jloop.LossConfig(max_disp=MAXDISP, preset=preset)
    mask_t = tloop.valid_mask(torch.from_numpy(gt), MAXDISP)
    mask_j = jloop.valid_mask(jnp.asarray(gt), MAXDISP)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    total_t, comps_t = tloop.compute_loss(
        Out(tuple(torch.from_numpy(v) for v in vols), tuple(torch.from_numpy(d) for d in disps), ()),
        torch.from_numpy(gt), mask_t, cfg_t)
    total_j, comps_j = jloop.compute_loss(
        Out(tuple(jnp.asarray(v) for v in vols), tuple(jnp.asarray(d) for d in disps), ()),
        jnp.asarray(gt), mask_j, cfg_j)
    assert set(comps_t) == set(comps_j)
    for k in comps_j:
        _close(comps_t[k], comps_j[k], rtol=1e-4)
    _close(total_t, total_j, rtol=1e-4)


def test_parse_lr_spec():
    assert ts.parse_lr_spec("12,20,24,28:2") == js.parse_lr_spec("12,20,24,28:2") == ([12, 20, 24, 28], 2.0)


@pytest.mark.parametrize(
    "name,args",
    [
        ("epoch_decay_schedule", (1e-3, "2,4,5:2", 3)),
        ("epoch_decay_schedule", (1e-3, "1:10", 7)),
        ("piecewise_lr_schedule", ([1e-3, 1e-4, 1e-5], [2, 3], 4)),
        ("kitti_finetune_schedule", (2,)),
    ],
)
def test_lr_schedule_matches_optax_at_step_boundaries(name, args):
    """The LR at step k equals optax's schedule(k), around every boundary."""
    port, jax_sched = getattr(ts, name)(*args), getattr(js, name)(*args)
    steps_per_epoch = args[-1]
    boundaries = {0, 1, 299 * steps_per_epoch, 300 * steps_per_epoch, 600 * steps_per_epoch}
    for e in range(0, 8):
        boundaries |= {e * steps_per_epoch - 1, e * steps_per_epoch, e * steps_per_epoch + 1}
    for k in sorted(b for b in boundaries if b >= 0):
        assert port(k) == pytest.approx(float(jax_sched(k)), rel=1e-6, abs=0), (name, k)


def test_adam_on_schedule_matches_optax():
    """make_adam + TrainState.apply_gradients against optax.adam on the same
    schedule and gradients, over steps that cross an LR boundary."""
    from dcanet_tpu_torch.train.state import TrainState

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((6, 5)).astype(np.float32)
    sched_t, sched_j = ts.epoch_decay_schedule(1e-2, "1,2:4", 2), js.epoch_decay_schedule(1e-2, "1,2:4", 2)

    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    state = TrainState(model=None, optimizer=ts.make_adam([p], sched_t), lr_fn=sched_t)
    tx = js.make_adam(sched_j)
    wj = jnp.asarray(w0)
    opt = tx.init(wj)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
        upd, opt = tx.update(jnp.asarray(g), opt, wj)
        wj = optax.apply_updates(wj, upd)
    assert state.step == len(grads)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(wj), rtol=0, atol=1e-6)
