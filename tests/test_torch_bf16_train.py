"""The port's bf16 train step against the JAX package's bf16 `train_step`,
on the CPU: DCANet(maxdisp=32, num_cva=1), one Adam step from the same
variables (`weights.from_jax_variables`) on the same numpy batch, 32x64, at
batch 1 and batch 2 (tests/test_train_step.py:15).

- The JAX side: `FlaxDCANet(..., dtype=bfloat16)` (bf16 compute over f32
  parameters) with `dcanet_tpu/train/loop.py::train_step` for the metrics
  and the BatchNorm statistics; the per-parameter gradients from `jax.grad`
  of the same loss, whose forward also reads each top-level stage (flax's
  `capture_intermediates`, the inputs by `nn.intercept_methods`, as
  tests/test_torch_bf16_stages.py does). The same again at float32: the
  JAX package's own bf16-vs-f32 distance on the same step. And the bf16
  step once more compiled with XLA's `xla_allow_excess_precision` off
  ("rounded"): XLA keeps the f32 value between the bf16 ops it fuses by
  default, where eager PyTorch rounds every op's output to bf16; with the
  option off XLA rounds them too. Nothing in the JAX package changes.
- The port side: `create_train_state(model, lr_fn, torch.bfloat16)` (bf16
  autocast over f32 parameters) with `train/loop.py::train_step`, hooks on
  its top-level modules; the gradients are read after the step.

Distances (port bf16 against JAX bf16), each beside the JAX package's own
bf16-vs-f32 distance of the same quantity: the loss terms, grad norm and
EPE (relative), the BatchNorm statistics after the step (relative L2 of
each key and of all), each parameter's gradient (relative L2) and the
whole gradient, the ladder's disparities and probability volumes of the
train forward (mean |.|), and each stage (scaled max, printed: a miss names
its site). Printed with `-s`.

Against the JAX bf16 step as XLA compiles it by default the bound is twice
the JAX package's own distance. The two f32 steps agree to 1e-5
(test_f32_steps_agree), so by the triangle inequality a port bf16 step
whose own bf16-vs-f32 error is no larger than the JAX package's sits at
most twice that distance from the JAX bf16 step; a distance above it
proves the port's bf16 rounds worse. Measured (printed): the port sits
1.0-1.7x the JAX package's own distance, so the plain 1x bound is missed
(ROADMAP Queue 3 item 3). The cause is the excess precision: against the
rounded JAX step the port sits within the JAX package's own distance (1x)
for the whole gradient, the median parameter, the BatchNorm statistics and
every rung of the ladders, and the rounded JAX step is farther from f32
than the default one (test_bf16_step_within_the_rounded_jax_distance).
The scalar metrics take the JAX distance as the larger of the two batches'
relative distances and twice it in both comparisons: one step's distance
of one scalar is one draw of its rounding noise and can fall near 0 by
chance. Neither the SLC statistics nor the heads nor the convex blend in
bf16 move the port toward the JAX step (ROADMAP Queue 3 item 3).

The port's counterpart of tests/test_train_step.py::test_bf16_training_tracks_f32:
20 bf16 steps against 20 f32 steps of the port from one reference init on
one batch of 2, mean relative loss gap under 0.05 (the JAX package's own
bound), the bf16 loss falling.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import unflatten_dict

from dcanet_tpu.models import DCANet as FlaxDCANet
from dcanet_tpu.train import loop as jloop
from dcanet_tpu.train import schedule as jsched
from dcanet_tpu.train.state import TrainState as FlaxTrainState
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_bf16_stages import _flat, jax_stages, port_stages, scaled
from test_torch_train import LR_SPEC, MAXDISP, STEPS_PER_EPOCH, H, Wd, _flat_variables, _flatten, _nchw

torch.set_num_threads(2)

BOUND = 2.0  # times the JAX package's own bf16-vs-f32 distance (module docstring)
BATCHES = (1, 2)
METRICS = ("total", "focal", "smooth_l1", "grad_norm", "epe")


def _batch(b, seed=5):
    rng = np.random.default_rng(seed)
    left = rng.standard_normal((b, H, Wd, 3)).astype(np.float32)
    right = rng.standard_normal((b, H, Wd, 3)).astype(np.float32)
    disp = rng.uniform(1.0, MAXDISP - 2.0, (b, H, Wd)).astype(np.float32)
    return left, right, disp


def _jax_step(flat, batch, dtype, excess_precision=True):
    """The JAX package's step: (metrics, {params/...: gradient}, {batch_stats/...
    after the step}, disparities, prob volumes, stages); compiled with XLA's
    `xla_allow_excess_precision` off when `excess_precision` is False."""
    options = {} if excess_precision else {"xla_allow_excess_precision": False}
    variables = unflatten_dict(flat, sep="/")
    left, right, disp = (jnp.asarray(x) for x in batch)
    model = FlaxDCANet(maxdisp=MAXDISP, num_cva=1, dtype=dtype)
    cfg = jloop.LossConfig(max_disp=MAXDISP)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

    def top_level(module):
        return module.scope is not None and len(module.scope.path) == 1

    def interceptor(next_fun, args, kwargs, ctx):
        if ctx.method_name == "__call__" and top_level(ctx.module):
            arrays = tuple(a for a in args if not isinstance(a, bool))
            ctx.module.sow("intermediates", "args", (arrays, {k: v for k, v in kwargs.items() if v is not None}))
        return next_fun(*args, **kwargs)

    def loss_fn(p):
        with fnn.intercept_methods(interceptor):
            out, upd = model.apply({"params": p, "batch_stats": stats}, left, right, train=True,
                                   mutable=["batch_stats", "intermediates"],
                                   capture_intermediates=lambda m, meth: meth == "__call__" and top_level(m))
        loss, _ = jloop.compute_loss(out, disp, jloop.valid_mask(disp, MAXDISP), cfg)
        return loss, (out, upd["intermediates"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    grads, (out, inter) = grad_fn.lower(params).compile(compiler_options=options)(params)
    grads = {f"params/{k}": np.asarray(v, np.float32) for k, v in _flatten(grads).items()}
    disparities = [np.asarray(x, np.float32) for x in out.disparities]
    probs = [np.asarray(x, np.float32) for x in out.prob_volumes]
    stages = jax_stages("dcanet-cva1", disparities[-1][:1], _flat(jax.tree.map(lambda x: x[:1], inter)))

    tx = jsched.make_adam(jsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    state = FlaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    jbatch = {"left": left, "right": right, "disparity": disp}
    new, metrics = jloop.train_step.lower(state, jbatch, cfg).compile(compiler_options=options)(state, jbatch)
    new_stats = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(new.batch_stats).items()}
    return {k: float(v) for k, v in metrics.items()}, grads, new_stats, disparities, probs, stages


def _port_step(flat, batch, amp):
    """The port's step, as `_jax_step` returns it."""
    left, right, disp = batch
    model = DCANet(maxdisp=MAXDISP, num_cva=1)
    model.load_state_dict(W.from_jax_variables(flat, 1), strict=True)
    state = create_train_state(model, tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH), amp)
    outs, ins, handles = {}, {}, []
    for name, module in model.named_children():
        handles.append(module.register_forward_hook(lambda m, a, o, n=name: outs.__setitem__(n, o)))
        handles.append(module.register_forward_pre_hook(lambda m, a, n=name: ins.__setitem__(n, a)))
    handles.append(model.register_forward_hook(lambda m, a, o: outs.__setitem__("", o)))
    try:
        metrics = tloop.train_step(state, {"left": _nchw(left), "right": _nchw(right),
                                           "disparity": torch.from_numpy(disp)}, tloop.LossConfig(max_disp=MAXDISP))
    finally:
        for h in handles:
            h.remove()
    params = dict(model.named_parameters())
    sd = model.state_dict()
    grads = W.to_jax_variables({k: params[k].grad if k in params else v for k, v in sd.items()}, 1)
    grads = {k: v for k, v in grads.items() if k.startswith("params/")}
    new_stats = {k: v for k, v in W.to_jax_variables(sd, 1).items() if k.startswith("batch_stats/")}
    out = outs.pop("")
    disparities = [x.detach().float().numpy() for x in out.disparities]
    probs = [x.detach().float().numpy() for x in out.prob_volumes]
    first = lambda t: t[:1].detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    outs = {k: (tuple(first(t) for t in v) if isinstance(v, tuple) else {n: first(t) for n, t in v.items()}
                if isinstance(v, dict) else first(v)) for k, v in outs.items()}
    ins = {k: tuple(first(t) for t in v) for k, v in ins.items()}
    stages = port_stages("dcanet-cva1", disparities[-1][:1], outs, ins)
    return {k: float(v) for k, v in metrics.items()}, grads, new_stats, disparities, probs, stages


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def _cat(d, keys):
    return np.concatenate([d[k].ravel() for k in keys])


@pytest.fixture(scope="module")
def steps():
    """Per batch size: {"jax bf16", "jax bf16 rounded", "jax f32", "port bf16",
    "port f32"} -> step."""
    flat = _flat_variables(1, seed=5)
    out = {}
    for b in BATCHES:
        batch = _batch(b)
        out[b] = {"jax bf16": _jax_step(flat, batch, jnp.bfloat16),
                  "jax bf16 rounded": _jax_step(flat, batch, jnp.bfloat16, excess_precision=False),
                  "jax f32": _jax_step(flat, batch, None),
                  "port bf16": _port_step(flat, batch, torch.bfloat16), "port f32": _port_step(flat, batch, None)}
    _print_tables(out)
    return out


def _print_tables(out):
    for b, s in out.items():
        for ref in ("jax bf16", "jax bf16 rounded"):
            _print_table(b, ref, s[ref], s["jax f32"], s["port bf16"], s["port f32"])


def _print_table(b, ref, jb, jf, pb, pf):
    print(f"\n[bf16 train step, batch {b}, against the {ref} step] metric: JAX bf16 / JAX f32 / port bf16 / "
          "port f32; |port bf16 - JAX bf16| vs |JAX bf16 - JAX f32|")
    for k in METRICS:
        print(f"  {k:10s} {jb[0][k]:.6f} / {jf[0][k]:.6f} / {pb[0][k]:.6f} / {pf[0][k]:.6f}; "
              f"{abs(pb[0][k] - jb[0][k]):.4e} vs {abs(jb[0][k] - jf[0][k]):.4e}")
    keys, skeys = sorted(jb[1]), sorted(jb[2])
    ratios = [_rel(pb[1][k], jb[1][k]) / max(_rel(jf[1][k], jb[1][k]), 1e-30) for k in keys]
    print(f"  whole gradient (rel L2): port-JAX bf16 {_rel(_cat(pb[1], keys), _cat(jb[1], keys)):.4f}, JAX "
          f"bf16-f32 {_rel(_cat(jf[1], keys), _cat(jb[1], keys)):.4f}, port bf16-f32 "
          f"{_rel(_cat(pb[1], keys), _cat(pf[1], keys)):.4f}, port f32-JAX f32 "
          f"{_rel(_cat(pf[1], keys), _cat(jf[1], keys)):.4f}")
    print(f"  per parameter ({len(keys)}): port-JAX over JAX bf16-f32 median {np.median(ratios):.4f}, max "
          f"{max(ratios):.4f}, above 1: {sum(r > 1 for r in ratios)}, above sqrt(2): "
          f"{sum(r > math.sqrt(2) for r in ratios)}")
    sratios = [_rel(pb[2][k], jb[2][k]) / max(_rel(jf[2][k], jb[2][k]), 1e-30) for k in skeys]
    print(f"  BatchNorm statistics (rel L2): port-JAX bf16 {_rel(_cat(pb[2], skeys), _cat(jb[2], skeys)):.4e}, "
          f"JAX bf16-f32 {_rel(_cat(jf[2], skeys), _cat(jb[2], skeys)):.4e}; per statistic ({len(skeys)}) "
          f"median {np.median(sratios):.4f}, max {max(sratios):.4f}, above 1: {sum(r > 1 for r in sratios)}")
    for name, i in (("disparities", 3), ("prob volumes", 4)):
        print(f"  {name} (mean |.|): port-JAX bf16 "
              + " ".join(f"{np.abs(p - j).mean():.4f}" for p, j in zip(pb[i], jb[i])) + "; JAX bf16-f32 "
              + " ".join(f"{np.abs(j - f).mean():.4f}" for j, f in zip(jb[i], jf[i])))
    print(f"  {'stage (scaled max, sample 0)':30s} {'port-JAX bf16':>14s} {'JAX bf16-f32':>13s} "
          f"{'port bf16-f32':>14s} {'port-JAX f32':>13s}")
    for k in jb[5]:
        print(f"  {k:30s} {scaled(pb[5][k], jb[5][k]):14.4e} {scaled(jf[5][k], jb[5][k]):13.4e} "
              f"{scaled(pb[5][k], pf[5][k]):14.4e} {scaled(pf[5][k], jf[5][k]):13.4e}")


def _jax_metric_scale(steps, key, ref="jax bf16"):
    """The JAX package's own relative bf16-vs-f32 distance of a metric, the
    larger over the test's two steps."""
    return max(abs(s[ref][0][key] - s["jax f32"][0][key]) / abs(s[ref][0][key]) for s in steps.values())


def test_f32_steps_agree(steps):
    """The reference for the rest: at f32 the two steps are one computation
    (tests/test_torch_train_step.py's tolerances)."""
    for s in steps.values():
        jf, pf = s["jax f32"], s["port f32"]
        for k in METRICS:
            tol = 2e-2 if k == "epe" else (1e-3 if k == "grad_norm" else 1e-4) * abs(jf[0][k])
            assert abs(pf[0][k] - jf[0][k]) <= tol, (k, pf[0][k], jf[0][k])
        keys = sorted(jf[1])
        assert _rel(_cat(pf[1], keys), _cat(jf[1], keys)) < 1e-2


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("key", METRICS)
def test_bf16_metrics_within_the_jax_distance(steps, b, key):
    jb, pb = steps[b]["jax bf16"][0], steps[b]["port bf16"][0]
    got = abs(pb[key] - jb[key]) / abs(jb[key])
    assert math.isfinite(pb[key]) and got <= BOUND * _jax_metric_scale(steps, key), (key, got)


@pytest.mark.parametrize("b", BATCHES)
def test_bf16_gradients_within_the_jax_distance(steps, b):
    """Each parameter's gradient and the whole gradient, relative in L2."""
    jb, jf, pb = steps[b]["jax bf16"][1], steps[b]["jax f32"][1], steps[b]["port bf16"][1]
    keys = sorted(jb)
    assert set(pb) == set(jb) and len(keys) == 280
    assert _rel(_cat(pb, keys), _cat(jb, keys)) <= BOUND * _rel(_cat(jf, keys), _cat(jb, keys))
    far = [(k, _rel(pb[k], jb[k]), _rel(jf[k], jb[k])) for k in keys if _rel(pb[k], jb[k]) > BOUND * _rel(jf[k], jb[k])]
    assert not far, far[:5]


@pytest.mark.parametrize("b", BATCHES)
def test_bf16_batch_norm_statistics_within_the_jax_distance(steps, b):
    jb, jf, pb = steps[b]["jax bf16"][2], steps[b]["jax f32"][2], steps[b]["port bf16"][2]
    keys = sorted(jb)
    assert set(pb) >= set(jb) and len(keys) == 176
    assert _rel(_cat(pb, keys), _cat(jb, keys)) <= BOUND * _rel(_cat(jf, keys), _cat(jb, keys))
    far = [k for k in keys if _rel(pb[k], jb[k]) > BOUND * _rel(jf[k], jb[k])]
    assert not far, far[:5]


@pytest.mark.parametrize("b", BATCHES)
def test_bf16_train_ladders_within_the_jax_distance(steps, b):
    """The train forward's disparities (full resolution) and probability
    volumes, mean |port - JAX| per rung."""
    s = steps[b]
    for i in (3, 4):
        rungs = list(zip(s["port bf16"][i], s["jax bf16"][i], s["jax f32"][i]))
        assert len(rungs) == (2 if i == 3 else 1)
        for p, j, f in rungs:
            assert p.shape == j.shape and np.isfinite(p).all()
            assert np.abs(p - j).mean() <= BOUND * np.abs(j - f).mean()


@pytest.mark.parametrize("b", BATCHES)
def test_bf16_step_within_the_rounded_jax_distance(steps, b):
    """Against the JAX bf16 step compiled without excess precision, which
    rounds every bf16 op as eager PyTorch does: the whole gradient, the
    median parameter's gradient, the BatchNorm statistics and each rung of
    the ladders within the JAX package's own bf16-vs-f32 distance (1x); the
    scalar metrics within twice it. The rounded JAX step is farther from
    f32 than the default one, and the port closer to it: the default's
    excess precision is what sets the two bf16 steps apart."""
    s = steps[b]
    jr, jd, jf, pb = s["jax bf16 rounded"], s["jax bf16"], s["jax f32"], s["port bf16"]
    keys, skeys = sorted(jr[1]), sorted(jr[2])

    def grad(a, ref):
        return _rel(_cat(a[1], keys), _cat(ref[1], keys))

    assert grad(jf, jr) > grad(jf, jd) and grad(pb, jr) < grad(pb, jd)
    assert grad(pb, jr) <= grad(jf, jr)
    assert np.median([_rel(pb[1][k], jr[1][k]) / _rel(jf[1][k], jr[1][k]) for k in keys]) <= 1.0
    assert _rel(_cat(pb[2], skeys), _cat(jr[2], skeys)) <= _rel(_cat(jf[2], skeys), _cat(jr[2], skeys))
    for i in (3, 4):
        for p, j, f in zip(pb[i], jr[i], jf[i]):
            assert np.abs(p - j).mean() <= np.abs(j - f).mean()
    for key in METRICS:
        got = abs(pb[0][key] - jr[0][key]) / abs(jr[0][key])
        assert got <= BOUND * _jax_metric_scale(steps, key, "jax bf16 rounded"), (key, got)


def _tracking_curve(amp):
    rng = np.random.default_rng(3)
    batch = {"left": torch.from_numpy(rng.standard_normal((2, 3, H, Wd)).astype(np.float32)),
             "right": torch.from_numpy(rng.standard_normal((2, 3, H, Wd)).astype(np.float32)),
             "disparity": torch.from_numpy(rng.uniform(1.0, MAXDISP - 2.0, (2, H, Wd)).astype(np.float32))}
    model = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=1), torch.Generator().manual_seed(3))
    state = create_train_state(model, lambda step: 1e-3, amp)
    cfg = tloop.LossConfig(max_disp=MAXDISP, preset="sceneflow")
    return np.asarray([float(tloop.train_step(state, batch, cfg)["total"]) for _ in range(20)])


def test_bf16_training_tracks_f32():
    f32, bf16 = _tracking_curve(None), _tracking_curve(torch.bfloat16)
    rel = np.abs(bf16 - f32) / np.abs(f32)
    print(f"\n[bf16 tracks f32] 20 steps, batch 2: mean relative loss gap {rel.mean():.4f} (bound 0.05), max "
          f"{rel.max():.4f}; bf16 loss {bf16[0]:.4f} -> {bf16[-1]:.4f}, f32 {f32[0]:.4f} -> {f32[-1]:.4f}")
    assert np.isfinite(bf16).all()
    assert bf16[-1] < bf16[0]
    assert rel.mean() < 0.05, (rel.mean(), bf16, f32)
