"""The KITTI training stage of the port against the JAX package's, on the CPU.

- One train step of the `kitti` preset (`LossConfig(preset="kitti",
  sparse=True)`: 5x focal on vol_0, 10x on vol_1 where the model has one,
  and the smooth-L1 ladder, every term on the sparse gt and its max-pooled
  copies; Adam on `kitti_finetune_schedule`) against the JAX package's
  `train_step`: FlaxDCANet(maxdisp=32, num_cva=1) and the port's DCANet from
  the same variables (`weights.from_jax_variables`, drawn as in
  tests/test_torch_train.py), on one batch of 2 crops of a procedural
  kitti_mix (`write_procedural_kitti_tree`, the kitti training transform,
  crop cut to 32x64): a KITTI 2012 and a KITTI 2015 scene.
  - f32, at tests/test_torch_train_step.py's tolerances: loss terms rtol
    1e-4, grad norm rtol 1e-3, EPE atol 2e-2, BatchNorm statistics 1e-3
    scaled by max(|x|, 1), the parameters after Adam's step as that file
    states. The gradients are held against the JAX package's gradient of
    the same loss in float64 (`jax.enable_x64`, the variables and the batch
    cast): the port's float64 step within 1e-6 of it (whole, relative L2)
    and each parameter within 1e-5 of its norm plus 1e-8 of the whole
    gradient's; the port's f32 step within 1e-4 (whole) and each parameter
    within 1e-3 of its norm plus 1e-6 of the whole gradient's (the biases
    that a BatchNorm follows have a gradient of 0 and keep only rounding).
    The JAX package's own f32 gradient is not the comparand: it sits
    ~1.1e-2 from its float64 gradient, nearly all of it in the feature
    extractor's convolutions (printed), where the port's f32 sits ~1e-5.
  - bf16 (autocast on the port, `dtype=bfloat16` in flax): within twice the
    JAX package's own bf16-vs-f32 distance on the same step (the bound of
    tests/test_torch_bf16_train.py, whose docstring gives the triangle
    argument and why 1x is out of reach): the loss terms, grad norm and EPE
    (relative), the whole gradient and the BatchNorm statistics (relative
    L2).
- The kitti loss alone with two volumes (5x vol_0 + 10x vol_1 + smooth-L1),
  value and gradient with respect to each volume and disparity, against
  the JAX `compute_loss` on random inputs (rtol 1e-5: the same f32 maths).
- `kitti_finetune_schedule` against the JAX schedule at its boundaries.
- `python -m dcanet_tpu_torch.finetune_kitti` on tiny trees (`--device
  cpu`, the crop cut to 32x64, batch 2, 1 epoch): the JSON's keys, the
  weights the fine-tune starts from equal to the export bit for bit, a
  fresh optimiser at step 0 and lr 1e-3, a checkpoint saved although the
  preset's save_after_epoch is 449, finite scores.
"""

import contextlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from chip_smoke import first_step_probe
from dcanet_tpu.models import DCANet as FlaxDCANet
from dcanet_tpu.train import loop as jloop
from dcanet_tpu.train import schedule as jsched
from dcanet_tpu.train.state import TrainState as FlaxTrainState
from dcanet_tpu_torch import cli, finetune_kitti
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.data.synthetic import write_procedural_kitti_tree
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.checkpoint import CheckpointManager
from dcanet_tpu_torch.train.state import create_train_state
from test_torch_train import MAXDISP, _flat_variables, _flatten, _scaled_close

torch.set_num_threads(2)

CROP, TREE_HW, STEPS_PER_EPOCH = (32, 64), (48, 160), 10
METRICS = ("total", "focal", "smooth_l1", "grad_norm", "epe")
BOUND = 2.0  # times the JAX package's own bf16-vs-f32 distance


@pytest.fixture(scope="module")
def kitti_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti_train")
    return (write_procedural_kitti_tree(base / "k12", "kitti2012", 2, TREE_HW, seed=11, workers=1),
            write_procedural_kitti_tree(base / "k15", "kitti2015", 2, TREE_HW, seed=12, workers=1),
            write_procedural_kitti_tree(base / "val", "kitti2015", 2, TREE_HW, seed=13, workers=1))


@pytest.fixture(scope="module")
def kitti_batch(kitti_trees):
    """A batch of 2 (a KITTI 2012 and a KITTI 2015 crop) through the kitti
    training transform, NHWC for flax."""
    k12, k15, _ = kitti_trees
    ds = cli.build_dataset(preset("kitti", data_root=str(k12), data_root2=str(k15)), training=True)
    ds.cfg = dict(ds.cfg, crop=CROP)
    ds.reseed(1)
    samples = [ds[0], ds[2]]
    left, right = (np.stack([s[k].transpose(1, 2, 0) for s in samples]) for k in ("left", "right"))
    disp = np.stack([s["disparity"] for s in samples])
    valid = (disp > 0) & (disp < MAXDISP)
    assert (disp == 0).mean() > 0.1 and 0.2 < valid.mean() < 0.95  # sparse, and mostly inside maxdisp
    return left, right, disp


def _jax_gradient(flat, batch, dtype=None, wide=False):
    """jax.grad of the JAX package's kitti loss (its `train_step`'s), flat;
    with `wide`, the variables, the batch and the maths in float64 (under
    `jax.enable_x64`)."""
    with jax.enable_x64(True) if wide else contextlib.nullcontext():
        cast = (lambda x: np.asarray(x, np.float64)) if wide else np.asarray  # noqa: E731
        variables = unflatten_dict({k: cast(v) for k, v in flat.items()}, sep="/")
        left, right, disp = (jnp.asarray(cast(x)) for x in batch)
        model = FlaxDCANet(maxdisp=MAXDISP, num_cva=1, dtype=dtype)
        cfg = jloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti")
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, left, right, train=True, mutable=["batch_stats"])
            return jloop.compute_loss(out, disp, jloop.valid_mask(disp, MAXDISP), cfg)[0]

        grads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, variables["params"]))
        return {f"params/{k}": np.asarray(v, np.float64 if wide else np.float32) for k, v in _flatten(grads).items()}


def _jax_step(flat, batch, dtype):
    """The JAX package's kitti step: (metrics, gradients, BatchNorm statistics
    and parameters after the step), flat."""
    variables = unflatten_dict(flat, sep="/")
    left, right, disp = (jnp.asarray(x) for x in batch)
    model = FlaxDCANet(maxdisp=MAXDISP, num_cva=1, dtype=dtype)
    cfg = jloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti")
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    tx = jsched.make_adam(jsched.kitti_finetune_schedule(STEPS_PER_EPOCH))
    state = FlaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    new, metrics = jloop.train_step(state, {"left": left, "right": right, "disparity": disp}, cfg)
    after = {f"batch_stats/{k}": np.asarray(v) for k, v in _flatten(new.batch_stats).items()}
    after.update({f"params/{k}": np.asarray(v) for k, v in _flatten(new.params).items()})
    return {k: float(v) for k, v in metrics.items()}, _jax_gradient(flat, batch, dtype), after


def _port_step(flat, batch, amp, dtype=torch.float32):
    """The port's kitti step, as `_jax_step` returns it; in float64 with
    `dtype` (the model and the batch)."""
    left, right, disp = batch
    model = DCANet(maxdisp=MAXDISP, num_cva=1)
    model.load_state_dict(W.from_jax_variables(flat, 1), strict=True)
    model.to(dtype)
    state = create_train_state(model, tsched.kitti_finetune_schedule(STEPS_PER_EPOCH), amp)
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)  # noqa: E731
    metrics = tloop.train_step(state, {"left": nchw(left), "right": nchw(right),
                                       "disparity": torch.from_numpy(disp).to(dtype)},
                               tloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti"))
    assert state.step == 1
    params = dict(model.named_parameters())
    sd = model.state_dict()
    grads = W.to_jax_variables({k: params[k].grad.double() if k in params else v for k, v in sd.items()}, 1)
    grads = {k: np.asarray(v, np.float64) for k, v in grads.items() if k.startswith("params/")}
    return {k: float(v) for k, v in metrics.items()}, grads, W.to_jax_variables(sd, 1)


@pytest.fixture(scope="module")
def steps(kitti_batch):
    flat = _flat_variables(1, seed=21)
    return {"flat": flat, "jax f32": _jax_step(flat, kitti_batch, None),
            "jax bf16": _jax_step(flat, kitti_batch, jnp.bfloat16),
            "port f32": _port_step(flat, kitti_batch, None), "port bf16": _port_step(flat, kitti_batch, torch.bfloat16),
            "port f64": _port_step(flat, kitti_batch, None, torch.float64),
            "jax f64": _jax_gradient(flat, kitti_batch, wide=True)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def _cat(d, keys):
    return np.concatenate([d[k].ravel() for k in keys])


@pytest.mark.parametrize("key", METRICS)
def test_kitti_step_metrics_match_jax(steps, key):
    got, want = steps["port f32"][0][key], steps["jax f32"][0][key]
    if key == "epe":
        assert got == pytest.approx(want, abs=2e-2)
    else:
        assert got == pytest.approx(want, rel=1e-3 if key == "grad_norm" else 1e-4)


def test_kitti_step_gradients_match_jax(steps):
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
    print("\n[kitti f32 step] whole gradient from JAX's float64: " + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
          + f"; per parameter over its margin at most: port f64 {worst(wide, 1e-5, 1e-8):.4f}, "
          f"port f32 {worst(got, 1e-3, 1e-6):.4f}")
    assert dist["port f64"] < 1e-6 and worst(wide, 1e-5, 1e-8) <= 1.0
    assert dist["port f32"] < 1e-4 and worst(got, 1e-3, 1e-6) <= 1.0


def test_kitti_step_bn_statistics_match_jax(steps):
    got, want = steps["port f32"][2], steps["jax f32"][2]
    keys = [k for k in want if k.startswith("batch_stats/")]
    assert len(keys) == 176
    for k in keys:
        _scaled_close(got[k], want[k], atol=1e-3)


def test_kitti_step_parameters_match_jax(steps):
    """Adam's first step at lr 1e-3, as tests/test_torch_train_step.py holds
    it: where both steps are within 0.1 % of +-lr they agree to 1e-5, at
    most 1 % of the elements elsewhere, no step above lr."""
    lr, flat = 1e-3, steps["flat"]
    got, want = steps["port f32"][2], steps["jax f32"][2]
    keys = [k for k in want if k.startswith("params/")]
    assert set(keys) == {k for k in flat if k.startswith("params/")}
    loose = total = 0
    for k in keys:
        d_got, d_want = got[k] - flat[k], want[k] - flat[k]
        firm = (np.sign(d_got) == np.sign(d_want)) & (np.minimum(np.abs(d_got), np.abs(d_want)) > 0.999 * lr)
        np.testing.assert_allclose(d_got[firm], d_want[firm], atol=1e-5, rtol=0, err_msg=k)
        assert np.abs(d_got).max() <= 1.01 * lr, k
        loose += int((~firm).sum())
        total += want[k].size
    assert loose <= 0.01 * total, (loose, total)


def _jax_metric_scale(steps, key):
    jb, jf = steps["jax bf16"][0][key], steps["jax f32"][0][key]
    return abs(jb - jf) / abs(jb)


@pytest.mark.parametrize("key", METRICS)
def test_kitti_bf16_metrics_within_the_jax_distance(steps, key):
    """One scalar's bf16-vs-f32 distance is one draw of its rounding noise,
    so the JAX distance is the largest over the loss terms (as
    tests/test_torch_bf16_train.py takes it over its batches)."""
    jb, pb = steps["jax bf16"][0][key], steps["port bf16"][0][key]
    got = abs(pb - jb) / abs(jb)
    scale = max(_jax_metric_scale(steps, k) for k in ("total", "focal", "smooth_l1", key))
    print(f"\n[kitti bf16 step] {key}: port {pb:.6f}, JAX bf16 {jb:.6f}, JAX f32 {steps['jax f32'][0][key]:.6f}; "
          f"{got:.3e} against the JAX distance {scale:.3e}")
    assert math.isfinite(pb) and got <= BOUND * scale, (key, got, scale)


@pytest.mark.parametrize("part", ["gradient", "batch_stats"])
def test_kitti_bf16_step_within_the_jax_distance(steps, part):
    i, prefix = (1, "params/") if part == "gradient" else (2, "batch_stats/")
    jb, jf, pb = steps["jax bf16"][i], steps["jax f32"][i], steps["port bf16"][i]
    keys = sorted(k for k in jb if k.startswith(prefix))
    got, own = _rel(_cat(pb, keys), _cat(jb, keys)), _rel(_cat(jf, keys), _cat(jb, keys))
    print(f"\n[kitti bf16 step] {part}: port-JAX bf16 {got:.4f} against JAX bf16-f32 {own:.4f} ({got / own:.2f}x)")
    assert np.isfinite(_cat(pb, keys)).all() and got <= BOUND * own


def test_kitti_loss_two_volumes_matches_jax():
    """5x focal on vol_0 and 10x on vol_1 (the sparse max-pooled gt at 1/4),
    plus the smooth-L1 ladder: value and gradients against the JAX loss."""
    rng = np.random.default_rng(4)
    b, h, w, d = 2, 32, 64, MAXDISP // 4
    vols = [rng.dirichlet(np.ones(d), (b, h // 4, w // 4)).transpose(0, 3, 1, 2).astype(np.float32) for _ in range(3)]
    disps = [rng.uniform(0, MAXDISP, (b, h, w)).astype(np.float32) for _ in range(2)]
    gt = np.where(rng.random((b, h, w)) < 0.3, rng.uniform(1, MAXDISP + 8, (b, h, w)), 0).astype(np.float32)

    class Out:
        def __init__(self, prob_volumes, disparities):
            self.prob_volumes, self.disparities = prob_volumes, disparities

    jcfg = jloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti")
    tcfg = tloop.LossConfig(max_disp=MAXDISP, sparse=True, preset="kitti")

    def jloss(v, dp):
        g = jnp.asarray(gt)
        return jloop.compute_loss(Out(v, dp), g, jloop.valid_mask(g, MAXDISP), jcfg)

    (jtotal, jcomps), jgrads = jax.value_and_grad(lambda v, dp: jloss(v, dp), argnums=(0, 1), has_aux=True)(
        [jnp.asarray(v) for v in vols], [jnp.asarray(x) for x in disps])
    tv = [torch.from_numpy(v).requires_grad_() for v in vols]
    td = [torch.from_numpy(x).requires_grad_() for x in disps]
    tgt = torch.from_numpy(gt)
    total, comps = tloop.compute_loss(Out(tv, td), tgt, tloop.valid_mask(tgt, MAXDISP), tcfg)
    total.backward()
    for k in ("total", "focal", "smooth_l1"):
        assert float(comps[k].detach()) == pytest.approx(float(jcomps[k]), rel=1e-5), k
    for got, want in zip(tv[:2], jgrads[0][:2]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert float(tv[1].grad.abs().max()) > 0
    assert tv[2].grad is None and not np.asarray(jgrads[0][2]).any()  # only vol_0 and vol_1 enter the loss
    for got, want in zip(td, jgrads[1]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("epoch", [0, 299, 300, 599, 600, 900])
def test_kitti_finetune_schedule_matches_jax(epoch):
    steps = 7
    for step in (epoch * steps, epoch * steps + steps - 1):
        assert tsched.kitti_finetune_schedule(steps)(step) == pytest.approx(
            float(jsched.kitti_finetune_schedule(steps)(step)), rel=1e-6)


def test_finetune_kitti_main_cpu(kitti_trees, tmp_path, monkeypatch):
    monkeypatch.setitem(tds.PRESETS, "kitti", dict(tds.PRESETS["kitti"], crop=CROP))
    monkeypatch.setattr(finetune_kitti, "PRINT_FREQ", 1)  # a read per step: ms/step from 2 steps
    k12, k15, val = kitti_trees
    pre = tmp_path / "pretrain"
    CheckpointManager(pre / "ckpt").save(cli.build_train_state(preset("sceneflow", seed=4), 1, "cpu"))
    starts = []
    out, logdir = tmp_path / "finetune.json", tmp_path / "run"
    with first_step_probe(starts):
        finetune_kitti.main(["--pretrain", str(pre / "ckpt"), "--k12", str(k12), "--k15", str(k15), "--val", str(val),
                             "--epochs", "1", "--batch", "2", "--dtype", "bfloat16", "--logdir", str(logdir),
                             "--out", str(out), "--device", "cpu"])
    result = json.loads(out.read_text())
    assert {"workflow", "preset", "batch", "curve"} <= set(result) and result["batch"] == 2
    assert (result["device"], result["dtype"], result["train_steps"]) == ("cpu", "bfloat16", 2)
    assert result["peak_memory_bytes"] == "not measured" and result["ms_per_step"] > 0 and result["pairs_per_s"] > 0
    assert [r["tag"] for r in result["curve"]] == ["pretrained (sceneflow weights, domain gap)", "finetuned 1 epochs"]
    for r in result["curve"]:
        assert math.isfinite(r["val_epe"]) and math.isfinite(r["val_d1"]) and r["eval_s"] > 0
    start = starts[0]
    assert (start["step"], start["adam_entries"], start["lr"]) == (0, 0, pytest.approx(1e-3))
    assert (start["loss_cfg"].preset, start["loss_cfg"].sparse) == ("kitti", True)
    export = torch.load(logdir / "pretrained_export.pt", weights_only=True)["state_dict"]
    pretrained = torch.load(sorted((pre / "ckpt").iterdir())[-1], weights_only=True)["model"]
    assert start["weights"].keys() == export.keys() == pretrained.keys()
    for k in export:
        assert torch.equal(start["weights"][k], export[k]) and torch.equal(export[k], pretrained[k]), k
    assert [p.name for p in (logdir / "ckpt").iterdir()] == ["ckpt_00000002.pt"]
