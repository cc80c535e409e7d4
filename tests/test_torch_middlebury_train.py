"""The ETH3D and Middlebury training stages of the port against the JAX
package's, on the CPU.

One train step of the `smooth_l1` loss preset (the smooth-L1 ladder alone,
on the dense gt inside 0 < gt < maxdisp; Adam on the presets' schedule
`epoch_decay_schedule(1e-3, "12,20,24,28:2")`) against the JAX package's
`train_step`, for each preset: FlaxDCANet(num_cva=1) and the port's DCANet
from the same variables (`weights.from_jax_variables`, drawn as in
tests/test_torch_train.py), on one batch of 2 crops of a procedural tree
(`write_procedural_eth3d_tree` / `write_procedural_middlebury_tree`, the
preset's training transform with the crop cut to 32x64). The presets'
maxdisp scaled to the test: ETH3D's 192 -> 32 (D = 8 at 1/4), Middlebury's
240 -> 48 (D = 12, as 60 is not a multiple of 8; the CVA's pooling takes it
to 6 and back to 12), its scenes halved (`half_res`) with disparities past
48 that the mask drops.
- f32, at tests/test_torch_train_step.py's tolerances: loss terms rtol
  1e-4, grad norm rtol 1e-3, EPE atol 2e-2, BatchNorm statistics 1e-3
  scaled by max(|x|, 1), the parameters after Adam's step as that file
  states. The gradients are held against the JAX package's gradient of the
  same loss in float64 (`jax.enable_x64`), as tests/test_torch_kitti_train.py
  holds them: the port's float64 step within 1e-6 (whole, relative L2) and
  each parameter within 1e-5 of its norm plus 1e-8 of the whole gradient's;
  the port's f32 step within F32_GRADIENT_BOUND of its preset (whole). How
  far an f32 step lies from its float64 one depends on the batch and the
  weights, so that bound is set per preset from this file's readings (ETH3D
  1.706e-3, Middlebury 1.123e-5) with about 3x and 4x room, not at kitti's
  1e-4; a bf16 or TF32 rounding inside the f32 step lies above it. The
  per-parameter distances and the JAX package's own f32 gradient (1.3-2.4e-2
  from its float64) are printed beside them.
- bf16 (autocast on the port, `dtype=bfloat16` in flax): within twice the
  JAX package's own bf16-vs-f32 distance on the same step (the bound of
  tests/test_torch_bf16_train.py): the loss terms, grad norm and EPE
  (relative), the whole gradient and the BatchNorm statistics (relative L2).
The JAX step's f32 and bf16 gradients are read from Adam's first moment
after the step (mu = (1 - b1) g = 0.1 g, f32: 6e-8 relative), which spares
a compile each; three JAX compiles a preset, one of them in float64.
- `epoch_decay_schedule` at the presets' spec against the JAX schedule.
"""

import math

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
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.data.synthetic import write_procedural_eth3d_tree, write_procedural_middlebury_tree
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_train import _flat_variables, _flatten, _scaled_close

torch.set_num_threads(2)

CROP, LR_SPEC, STEPS_PER_EPOCH = (32, 64), "12,20,24,28:2", 10
# preset -> (maxdisp, full-resolution scene size, disparity range, tree seed)
PRESETS = {"eth3d": (32, (48, 96), (2.0, 40.0), 31), "middlebury": (48, (90, 170), (8.0, 136.0), 32)}
METRICS = ("total", "smooth_l1", "grad_norm", "epe")
BOUND = 2.0  # times the JAX package's own bf16-vs-f32 distance
# the port's f32 gradient from the JAX float64 gradient (whole, relative L2)
F32_GRADIENT_BOUND = {"eth3d": 5e-3, "middlebury": 5e-5}


def _batch(name, root):
    """A batch of 2 crops through the preset's training transform, NHWC for flax."""
    ds = cli.build_dataset(preset(name, data_root=str(root)), training=True)
    ds.cfg = dict(ds.cfg, crop=CROP)
    ds.reseed(1)
    samples = [ds[0], ds[1]]
    left, right = (np.stack([s[k].transpose(1, 2, 0) for s in samples]) for k in ("left", "right"))
    return left, right, np.stack([s["disparity"] for s in samples])


def _loss_cfg(module, maxdisp):
    return module.LossConfig(max_disp=maxdisp, preset="smooth_l1")


def _jax_gradient(flat, batch, maxdisp):
    """jax.grad of the JAX package's smooth_l1 loss (its `train_step`'s) with
    the variables, the batch and the maths in float64 (`jax.enable_x64`), flat."""
    with jax.enable_x64(True):
        wide = lambda x: np.asarray(x, np.float64)  # noqa: E731
        variables = unflatten_dict({k: wide(v) for k, v in flat.items()}, sep="/")
        left, right, disp = (jnp.asarray(wide(x)) for x in batch)
        model = FlaxDCANet(maxdisp=maxdisp, num_cva=1)
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, left, right, train=True, mutable=["batch_stats"])
            return jloop.compute_loss(out, disp, jloop.valid_mask(disp, maxdisp), _loss_cfg(jloop, maxdisp))[0]

        grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, variables["params"]))
        return {f"params/{k}": np.asarray(v, np.float64) for k, v in _flatten(grads).items()}


def _jax_step(flat, batch, maxdisp, dtype):
    """The JAX package's step: (metrics, gradients, BatchNorm statistics and
    parameters after the step), flat; the gradients from Adam's first moment."""
    variables = unflatten_dict(flat, sep="/")
    left, right, disp = (jnp.asarray(x) for x in batch)
    model = FlaxDCANet(maxdisp=maxdisp, num_cva=1, dtype=dtype)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    tx = jsched.make_adam(jsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    state = FlaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    new, metrics = jloop.train_step(state, {"left": left, "right": right, "disparity": disp}, _loss_cfg(jloop, maxdisp))
    adam = new.opt_state[0]
    assert int(adam.count) == 1
    grads = {f"params/{k}": np.asarray(v, np.float64) / 0.1 for k, v in _flatten(adam.mu).items()}
    after = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(new.batch_stats).items()}
    after.update({f"params/{k}": np.asarray(v) for k, v in _flatten(new.params).items()})
    return {k: float(v) for k, v in metrics.items()}, grads, after


def _port_step(flat, batch, maxdisp, amp, dtype=torch.float32):
    """The port's step, as `_jax_step` returns it; in float64 with `dtype`
    (the model and the batch). A parameter outside the loss has no
    gradient, as in the JAX package (zero there), and Adam skips it."""
    left, right, disp = batch
    model = DCANet(maxdisp=maxdisp, num_cva=1)
    model.load_state_dict(W.from_jax_variables(flat, 1), strict=True)
    model.to(dtype)
    state = create_train_state(model, tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH), amp)
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)  # noqa: E731
    metrics = tloop.train_step(state, {"left": nchw(left), "right": nchw(right),
                                       "disparity": torch.from_numpy(disp).to(dtype)}, _loss_cfg(tloop, maxdisp))
    assert state.step == 1
    params = dict(model.named_parameters())
    sd = model.state_dict()
    grads = W.to_jax_variables({k: (params[k].grad if params[k].grad is not None else torch.zeros_like(v)).double()
                                if k in params else v for k, v in sd.items()}, 1)
    grads = {k: np.asarray(v, np.float64) for k, v in grads.items() if k.startswith("params/")}
    return {k: float(v) for k, v in metrics.items()}, grads, W.to_jax_variables(sd, 1)


@pytest.fixture(scope="module", params=sorted(PRESETS))
def steps(request, tmp_path_factory):
    name = request.param
    maxdisp, hw, drange, seed = PRESETS[name]
    writer = write_procedural_eth3d_tree if name == "eth3d" else write_procedural_middlebury_tree
    root = writer(tmp_path_factory.mktemp(name), 2, hw, seed=seed, workers=1, disp_range=drange)
    batch = _batch(name, root)
    flat = _flat_variables(1, seed=41)
    return {"name": name, "maxdisp": maxdisp, "batch": batch, "flat": flat,
            "jax f32": _jax_step(flat, batch, maxdisp, None), "jax bf16": _jax_step(flat, batch, maxdisp, jnp.bfloat16),
            "port f32": _port_step(flat, batch, maxdisp, None),
            "port bf16": _port_step(flat, batch, maxdisp, torch.bfloat16),
            "port f64": _port_step(flat, batch, maxdisp, None, torch.float64),
            "jax f64": _jax_gradient(flat, batch, maxdisp)}


def test_batch_is_the_presets(steps):
    """The crops hold the dense gt with its unknown pixels at 0, and (for
    Middlebury, halved) gt past maxdisp that the mask drops."""
    left, right, disp = steps["batch"]
    maxdisp = steps["maxdisp"]
    assert left.shape == right.shape == (2, *CROP, 3) and disp.shape == (2, *CROP)
    valid = (disp > 0) & (disp < maxdisp)
    assert 0.5 < valid.mean() < 1.0 and (disp == 0).any()
    if steps["name"] == "middlebury":
        assert (disp >= maxdisp).any()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def _cat(d, keys):
    return np.concatenate([d[k].ravel() for k in keys])


@pytest.mark.parametrize("key", METRICS)
def test_step_metrics_match_jax(steps, key):
    """The loss terms and EPE against the JAX f32 step; the grad norm against
    the norm of the JAX package's float64 gradient, as the gradients below
    (the JAX f32 step's own norm printed beside it)."""
    got, want = steps["port f32"][0][key], steps["jax f32"][0][key]
    assert "focal" not in steps["port f32"][0] and "focal" not in steps["jax f32"][0]
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    elif key == "grad_norm":
        exact = float(np.linalg.norm(_cat(steps["jax f64"], sorted(steps["jax f64"]))))
        print(f"\n[{steps['name']} f32 step] grad norm: port {got:.6f}, JAX float64 {exact:.6f}, JAX f32 {want:.6f}")
        assert got == pytest.approx(exact, rel=1e-3)
    else:
        assert got == pytest.approx(want, rel=1e-4)


def test_step_gradients_match_jax(steps):
    """The port's float64 gradient within 1e-6 of the JAX package's float64
    gradient (whole) and each parameter's within 1e-5 of its norm plus 1e-8
    of the whole's; the port's f32 gradient within its preset's
    F32_GRADIENT_BOUND (whole). The per-parameter margins of the port's f32
    gradient and the JAX package's f32 distance are printed."""
    got, wide, exact, jax_f32 = steps["port f32"][1], steps["port f64"][1], steps["jax f64"], steps["jax f32"][1]
    keys = sorted(exact)
    assert set(got) == set(wide) == set(exact) == set(jax_f32) and len(keys) == 280
    norm = np.linalg.norm
    whole = norm(_cat(exact, keys))

    def worst(a, rtol, atol):
        """The largest per-parameter distance from JAX's float64 over its margin."""
        return max(norm(a[k] - exact[k]) / (rtol * norm(exact[k]) + atol * whole) for k in keys)

    dist = {name: _rel(_cat(a, keys), _cat(exact, keys))
            for name, a in (("port f64", wide), ("port f32", got), ("JAX f32", jax_f32))}
    print(f"\n[{steps['name']} f32 step] whole gradient from JAX's float64: "
          + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
          + f"; per parameter over its margin at most: port f64 {worst(wide, 1e-5, 1e-8):.4f}, "
          f"port f32 {worst(got, 1e-3, 1e-6):.4f}, JAX f32 {worst(jax_f32, 1e-3, 1e-6):.4f}")
    assert dist["port f64"] < 1e-6 and worst(wide, 1e-5, 1e-8) <= 1.0
    assert dist["port f32"] <= F32_GRADIENT_BOUND[steps["name"]]


def test_step_bn_statistics_match_jax(steps):
    got, want = steps["port f32"][2], steps["jax f32"][2]
    keys = [k for k in want if k.startswith("batch_stats/")]
    assert len(keys) == 176
    for k in keys:
        _scaled_close(got[k], want[k], atol=1e-3)


def _firm_agreement(d_got, d_want, lr):
    """The elements where both steps are within 0.1 % of +-lr with one sign
    agree to 1e-5; returns how many elements are not such."""
    firm = (np.sign(d_got) == np.sign(d_want)) & (np.minimum(np.abs(d_got), np.abs(d_want)) > 0.999 * lr)
    np.testing.assert_allclose(d_got[firm], d_want[firm], atol=1e-5, rtol=0)
    return int((~firm).sum())


def test_step_parameters_match_jax(steps):
    """Adam's first step at lr 1e-3, as tests/test_torch_train_step.py holds
    it, against the step that the JAX package's float64 gradient gives
    (-lr g / (|g| + 1e-8), optax's first step): where both are within 0.1 %
    of +-lr they agree to 1e-5, at most 1 % of the elements elsewhere, no
    step above lr (the JAX f32 step's share elsewhere printed beside it)."""
    lr, eps, flat = 1e-3, 1e-8, steps["flat"]
    got, want, exact = steps["port f32"][2], steps["jax f32"][2], steps["jax f64"]
    keys = [k for k in want if k.startswith("params/")]
    assert set(keys) == {k for k in flat if k.startswith("params/")} == set(exact)
    loose = loose_jax = total = 0
    for k in keys:
        d_got, d_want = got[k] - flat[k], want[k] - flat[k]
        d_exact = -lr * exact[k] / (np.abs(exact[k]) + eps)
        loose += _firm_agreement(d_got, d_exact, lr)
        loose_jax += _firm_agreement(d_want, d_exact, lr)
        assert np.abs(d_got).max() <= 1.01 * lr, k
        total += want[k].size
    print(f"\n[{steps['name']} f32 step] Adam's step off the float64 gradient's: port {loose / total:.4%}, "
          f"JAX f32 {loose_jax / total:.4%} of the elements")
    assert loose <= 0.01 * total, (loose, total)


@pytest.mark.parametrize("key", METRICS)
def test_bf16_metrics_within_the_jax_distance(steps, key):
    """One scalar's bf16-vs-f32 distance is one draw of its rounding noise,
    so the JAX distance is the largest over the loss terms and this one."""
    jb, pb, jf = steps["jax bf16"][0][key], steps["port bf16"][0][key], steps["jax f32"][0][key]
    got = abs(pb - jb) / abs(jb)
    scale = max(abs(steps["jax bf16"][0][k] - steps["jax f32"][0][k]) / abs(steps["jax bf16"][0][k])
                for k in ("total", "smooth_l1", key))
    print(f"\n[{steps['name']} bf16 step] {key}: port {pb:.6f}, JAX bf16 {jb:.6f}, JAX f32 {jf:.6f}; "
          f"{got:.3e} against the JAX distance {scale:.3e}")
    assert math.isfinite(pb) and got <= BOUND * scale, (key, got, scale)


@pytest.mark.parametrize("part", ["gradient", "batch_stats"])
def test_bf16_step_within_the_jax_distance(steps, part):
    i, prefix = (1, "params/") if part == "gradient" else (2, "batch_stats/")
    jb, jf, pb = steps["jax bf16"][i], steps["jax f32"][i], steps["port bf16"][i]
    keys = sorted(k for k in jb if k.startswith(prefix))
    got, own = _rel(_cat(pb, keys), _cat(jb, keys)), _rel(_cat(jf, keys), _cat(jb, keys))
    print(f"\n[{steps['name']} bf16 step] {part}: port-JAX bf16 {got:.4f} against JAX bf16-f32 {own:.4f} "
          f"({got / own:.2f}x)")
    assert np.isfinite(_cat(pb, keys)).all() and got <= BOUND * own


@pytest.mark.parametrize("epoch", [0, 11, 12, 19, 20, 24, 28, 299])
def test_presets_schedule_matches_jax(epoch):
    for name in ("eth3d", "middlebury"):
        spec = preset(name).lr_spec
        assert spec == LR_SPEC
        for step in (epoch * STEPS_PER_EPOCH, epoch * STEPS_PER_EPOCH + STEPS_PER_EPOCH - 1):
            assert tsched.epoch_decay_schedule(1e-3, spec, STEPS_PER_EPOCH)(step) == pytest.approx(
                float(jsched.epoch_decay_schedule(1e-3, spec, STEPS_PER_EPOCH)(step)), rel=1e-6)
