"""DCANet without the concat volume (`dcanet-g`) and the plain GwcNet
baselines (`gwcnet-g`, `gwcnet-gc`, `Hourglass3D`) of the port against the
JAX package, on the CPU.

Weights are drawn on the port's side (reference init, then BatchNorm affine
and statistics and conv biases randomised with numpy) and carried to flax
through `weights.to_jax_variables`; the tables are held against the flax
models' own variable trees (`jax.eval_shape` of their init) and against
tools/torch_mapping.py. Inputs 1x3x32x64; maxdisp 32 for dcanet-g, 16 for
the baselines. The JAX side runs eagerly.

Tolerances: the JAX package's own parity against the reference network
(tests/test_torch_parity.py): eval disparity atol 5e-3 px, train
disparities 2e-2, probability volumes 1e-3; cost and class logits atol
1e-4 (eval) / 1e-3 (train) after scaling by max(|x|, 1), since random
weights saturate the softmax and the disparity alone would not see a
difference below it; BatchNorm statistics 1e-3 scaled; one train step's
loss rtol 1e-4 and grad norm rtol 1e-3.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dcanet_tpu.models import registry as jregistry
from dcanet_tpu.nn.aggregation import Hourglass3D as FlaxHourglass3D
from dcanet_tpu.train import loop as jloop
from dcanet_tpu.train import schedule as jsched
from dcanet_tpu.train.state import TrainState as FlaxTrainState
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.models import DCANet, DCANetEvalOutput, DCANetTrainOutput, GwcNetBaseline
from dcanet_tpu_torch.models import registry as tregistry
from dcanet_tpu_torch.nn.aggregation import Hourglass3D
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.train import loop as tloop
from dcanet_tpu_torch.train import schedule as tsched
from dcanet_tpu_torch.train.state import create_train_state
from tools import torch_mapping

torch.set_num_threads(2)

H, Wd = 32, 64
MAXDISP = {"dcanet-g": 32, "gwcnet-g": 16, "gwcnet-gc": 16}
# the head whose cost logits are compared beside the disparity in eval
FINAL_HEAD = {"dcanet-g": "classif3", "gwcnet-g": "classif3", "gwcnet-gc": "classif3"}
LR_SPEC, STEPS_PER_EPOCH = "12,20,24,28:2", 10


def randomize(flat, seed):
    """BatchNorm affine and statistics and conv biases drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("/mean"):
            v = rng.normal(0.0, 0.2, v.shape)
        elif k.endswith("/var") or k.endswith("/scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/bias"):
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def port_and_flat(name, maxdisp, seed):
    """The registry's port model with random weights, and the same weights as
    flat flax variables."""
    model = reference_init_(tregistry.make_model(name, maxdisp=maxdisp), torch.Generator().manual_seed(seed))
    flat = randomize(W.to_jax_variables(model.state_dict(), model), seed)
    model.load_state_dict(W.from_jax_variables(flat, model), strict=True)
    return model, flat


def images(seed, h=H, w=Wd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, h, w, 3)).astype(np.float32) for _ in range(2))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def scaled_close(got, want, atol):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def head_output(model, name, fn):
    """fn()'s result and the output of the port model's head `name`, (B, D, H, W)."""
    seen = []
    handle = getattr(model, name).register_forward_hook(lambda m, i, o: seen.append(o[:, 0].detach()))
    try:
        out = fn()
    finally:
        handle.remove()
    return out, seen[-1]


def flax_head(state, name):
    return np.asarray(state["intermediates"][name]["__call__"][0])


# ---- weight tables ----

@pytest.mark.parametrize("use_concat", [True, False])
def test_gwcnet_table_matches_reference_mapping(use_concat):
    assert W.gwcnet_table(use_concat) == torch_mapping.gwcnet_baseline_mapping(use_concat)


def test_dcanet_g_table_matches_reference_mapping():
    """tools/torch_mapping.dcanet_mapping ignores its use_concat (it lists the
    concat head's lastconv rows for both); without those rows the tables agree."""
    want = torch_mapping.dcanet_mapping(3, use_concat=False)
    lastconv = [e for e in want if e[0].startswith("feature_extraction.lastconv.")]
    assert len(lastconv) == 3  # lastconv.0 conv and BN, lastconv.2 conv
    assert W.dcanet_table(3, use_concat=False) == [e for e in want if e not in lastconv]
    assert W.dcanet_table(3, use_concat=True) == want


@pytest.mark.parametrize("name", sorted(MAXDISP))
def test_table_covers_the_flax_variables(name):
    """Every variable of the flax model's init, and nothing else, by the
    registry name and by the model."""
    left, right = images(0)
    fmodel = jregistry.make_model(name, maxdisp=MAXDISP[name])
    shapes = jax.eval_shape(lambda: fmodel.init(jax.random.PRNGKey(0), left, right, train=True))
    want = {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
    model = tregistry.make_model(name, maxdisp=MAXDISP[name])
    for ref in (name, model):
        got = W.to_jax_variables(model.state_dict(), ref)
        assert {k: v.shape for k, v in got.items()} == want
    sd = W.from_jax_variables({k: np.zeros(s, np.float32) for k, s in want.items()}, name)
    model.load_state_dict(sd, strict=True)


def test_model_table_by_reference():
    assert W.model_table(3) == W.model_table("dcanet") == W.dcanet_table(3)
    assert W.model_table("dcanet-g") == W.dcanet_table(3, use_concat=False)
    assert W.model_table(GwcNetBaseline(maxdisp=16, use_concat_volume=False)) == W.gwcnet_table(False)
    with pytest.raises(TypeError, match="no key table"):
        W.model_table(Hourglass3D(4))


# ---- Hourglass3D ----

@pytest.fixture(scope="module")
def hourglass():
    c = 4
    block = reference_init_(Hourglass3D(c), torch.Generator().manual_seed(3))
    table = W.hourglass_table("", "")
    flat = randomize(W.flax_from_state_dict(block.state_dict(), table), 3)
    block.load_state_dict(W.state_dict_from_flax(flat, table), strict=True)
    x = np.random.default_rng(3).standard_normal((1, c, 8, 8, 16)).astype(np.float32)
    return block, flat, table, x


@pytest.mark.parametrize("train", [False, True])
def test_hourglass3d_matches_flax(hourglass, train):
    block, flat, table, x = hourglass
    block = copy.deepcopy(block).train(train)
    fblock = FlaxHourglass3D(4)
    xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    if train:
        want, upd = fblock.apply(unflatten_dict(flat, sep="/"), xj, True, mutable=["batch_stats"])
    else:
        want = fblock.apply(unflatten_dict(flat, sep="/"), xj, False)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert got.shape == x.shape
    scaled_close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3), atol=1e-4)
    if train:
        stats = W.flax_from_state_dict(block.state_dict(), table)
        for k, v in flatten_dict(upd["batch_stats"], sep="/").items():
            scaled_close(stats[f"batch_stats/{k}"], np.asarray(v), atol=1e-4)


# ---- the models, eval and train forwards ----

@pytest.fixture(scope="module")
def forwards():
    """Per name: the flax (eval output, eval head, train output, updated
    batch_stats) and the port's (eval output, eval head, train output, train
    model)."""
    left, right = images(1)
    results = {}
    for seed, name in enumerate(sorted(MAXDISP), start=10):
        model, flat = port_and_flat(name, MAXDISP[name], seed)
        fmodel = jregistry.make_model(name, maxdisp=MAXDISP[name])
        variables = unflatten_dict(flat, sep="/")
        head = FINAL_HEAD[name]
        fev, fstate = fmodel.apply(variables, left, right, train=False, mutable=["intermediates"],
                                   capture_intermediates=lambda mdl, _: mdl.name == head)
        ftr, fupd = fmodel.apply(variables, left, right, train=True, mutable=["batch_stats"])
        with torch.no_grad():
            tev, thead = head_output(model.eval(), head, lambda: model(nchw(left), nchw(right)))
            tmodel = copy.deepcopy(model).train()
            ttr = tmodel(nchw(left), nchw(right))
        results[name] = dict(fev=fev, fhead=flax_head(fstate, head), ftr=ftr, fstats=fupd["batch_stats"],
                             tev=tev, thead=thead, ttr=ttr, tmodel=tmodel)
    return results


@pytest.mark.parametrize("name", sorted(MAXDISP))
def test_eval_forward_matches_flax(forwards, name):
    r = forwards[name]
    assert isinstance(r["tev"], DCANetEvalOutput)
    got, want = r["tev"].disparity, np.asarray(r["fev"].disparity)
    assert got.shape == (1, H, Wd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)
    assert r["thead"].shape == (1, MAXDISP[name] // 4, H // 4, Wd // 4)
    scaled_close(r["thead"].numpy(), r["fhead"], atol=1e-4)
    assert len(r["tev"].class_logits) == len(r["fev"].class_logits) == (3 if name == "dcanet-g" else 0)
    for got, want in zip(r["tev"].class_logits, r["fev"].class_logits):
        scaled_close(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", sorted(MAXDISP))
def test_train_forward_matches_flax(forwards, name):
    r = forwards[name]
    got, want = r["ttr"], r["ftr"]
    assert isinstance(got, DCANetTrainOutput)
    lengths = (5, 2, 3) if name == "dcanet-g" else (0, 4, 0)
    assert (len(got.prob_volumes), len(got.disparities), len(got.class_logits)) == lengths
    assert (len(want.prob_volumes), len(want.disparities), len(want.class_logits)) == lengths
    for g, w in zip(got.prob_volumes, want.prob_volumes):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)
    for g, w in zip(got.disparities, want.disparities):
        assert g.shape == (1, H, Wd) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2, rtol=0)
    for g, w in zip(got.class_logits, want.class_logits):
        scaled_close(g.numpy(), np.asarray(w), atol=1e-3)
    stats = W.to_jax_variables(r["tmodel"].state_dict(), r["tmodel"])
    for k, v in flatten_dict(r["fstats"], sep="/").items():
        scaled_close(stats[f"batch_stats/{k}"], np.asarray(v), atol=1e-3)


def test_dcanet_g_has_no_concat_volume():
    model = tregistry.make_model("dcanet-g", maxdisp=32)
    assert isinstance(model, DCANet) and not model.use_concat_volume
    assert model.feature_extraction.lastconv is None
    assert model.dres0[0][0].in_channels == 40
    assert tregistry.make_model("dcanet", maxdisp=32).dres0[0][0].in_channels == 64


# ---- one train step against the JAX train_step ----

def one_train_step(name, maxdisp, seed):
    """One Adam step from the same weights in both frameworks on one pair;
    returns (JAX metrics, port metrics)."""
    model, flat = port_and_flat(name, maxdisp, seed)
    left, right = images(seed)
    disp = np.random.default_rng(seed).uniform(1.0, maxdisp - 2.0, (1, H, Wd)).astype(np.float32)
    variables = unflatten_dict(flat, sep="/")
    fmodel = jregistry.make_model(name, maxdisp=maxdisp)
    tx = jsched.make_adam(jsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    params = jax.tree.map(jnp.asarray, variables["params"])
    fstate = FlaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), apply_fn=fmodel.apply, tx=tx,
    )
    batch = {"left": jnp.asarray(left), "right": jnp.asarray(right), "disparity": jnp.asarray(disp)}
    _, fmetrics = jloop.train_step(fstate, batch, jloop.LossConfig(max_disp=maxdisp))
    state = create_train_state(model, tsched.epoch_decay_schedule(1e-3, LR_SPEC, STEPS_PER_EPOCH))
    tbatch = {"left": nchw(left), "right": nchw(right), "disparity": torch.from_numpy(disp)}
    tmetrics = tloop.train_step(state, tbatch, tloop.LossConfig(max_disp=maxdisp))
    return fmetrics, tmetrics


def test_train_step_matches_jax_gwcnet_gc():
    fmetrics, tmetrics = one_train_step("gwcnet-gc", 16, seed=21)
    assert "focal" not in tmetrics  # no probability ladder
    for key, rel in (("total", 1e-4), ("smooth_l1", 1e-4), ("grad_norm", 1e-3)):
        assert float(tmetrics[key]) == pytest.approx(float(fmetrics[key]), rel=rel), key
    assert float(tmetrics["epe"]) == pytest.approx(float(fmetrics["epe"]), abs=2e-2)


# ---- the commands ----

def test_cli_train_gwcnet_g(tmp_path, monkeypatch, capsys):
    from test_torch_cli import _tiny_sceneflow

    root = _tiny_sceneflow(tmp_path, monkeypatch)
    hist = cli.main(["train", "--preset", "sceneflow", "--model", "gwcnet-g", "--data-root", str(root),
                     "--logdir", str(tmp_path / "run"), "--maxdisp", "16", "--batch-size", "2", "--epochs", "1",
                     "--num-workers", "2", "--print-freq", "1", "--seed", "3", "--device", "cpu"])
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r[k]) for r in hist for k in ("total", "smooth_l1", "grad_norm", "epe"))
    assert all("focal" not in r for r in hist)
    payload = torch.load(tmp_path / "run" / "ckpt" / "ckpt_00000002.pt", weights_only=True)
    model = GwcNetBaseline(maxdisp=16, use_concat_volume=False)
    model.load_state_dict(payload["model"], strict=True)
    assert "epoch 0 step 2/2 loss " in capsys.readouterr().out


def test_cli_eval_gwcnet_gc_has_no_class_scores(tmp_path):
    """`cli eval --model gwcnet-gc` on a 2-pair tree: the metrics of direct
    model calls and no vol<i> scores, as the JAX cmd_eval with an empty
    tuple of class logits."""
    from dcanet_tpu_torch.data.eval_protocol import eval_transform
    from dcanet_tpu_torch.data.submission import unpad
    from dcanet_tpu_torch.data.synthetic import write_kitti2015_tree
    from dcanet_tpu_torch.train.metrics import per_image_metrics

    root = write_kitti2015_tree(tmp_path / "kitti", 2, (48, 96), seed=4, max_disp=12, maxdisp=16)
    res = cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(root),
                    "--model", "gwcnet-gc", "--maxdisp", "16", "--logdir", str(tmp_path / "run"),
                    "--log-images", "1", "--seed", "6", "--device", "cpu"])
    assert set(res) == {"epe", "d1", "thres1", "thres2", "thres3", "ms_per_pair", "pairs_per_s"}
    model = cli.build_model("gwcnet-gc", 16, device="cpu", seed=6)
    ds = cli.build_dataset(preset("kitti", dataset="kitti2015", data_root=str(root)), training=False)
    sums, kept = {}, 0
    for i in range(len(ds)):
        left, right, gt, pads = eval_transform(ds[i], "kitti")
        with torch.inference_mode():
            disp = model(torch.from_numpy(left[None]), torch.from_numpy(right[None])).disparity
        disp = unpad(disp[0], pads)[None]
        gt_t = torch.from_numpy(gt)[None]
        m = {k: float(v) for k, v in per_image_metrics(disp, gt_t, (gt_t > 0) & (gt_t < 16)).items()}
        n = m.pop("n_valid_images")
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v * n
        kept += n
    assert kept == 2
    for k in ("epe", "d1", "thres1", "thres2", "thres3"):
        assert res[k] == pytest.approx(sums[k] / kept, rel=1e-5, abs=1e-7), k
    assert sorted(p.name for p in (tmp_path / "run" / "images").iterdir()) == ["eval_sample0_00000000.png"]


def test_debug_nans_raises_at_the_first_nan_backward(tmp_path, monkeypatch):
    """`RunConfig.debug_nans`: with a NaN injected into a weight, the step's
    backward raises under anomaly detection; without it the step runs on to
    a NaN loss."""
    from test_torch_cli import _tiny_sceneflow

    root = _tiny_sceneflow(tmp_path, monkeypatch)
    build = cli.build_train_state

    def poisoned(*args, **kwargs):
        state = build(*args, **kwargs)
        with torch.no_grad():
            state.model.classif3[2].weight[0, 0, 0, 0, 0] = float("nan")
        return state

    monkeypatch.setattr(cli, "build_train_state", poisoned)

    def run(debug_nans, logdir):
        cfg = preset("sceneflow", model="gwcnet-g", data_root=str(root), logdir=str(logdir), maxdisp=16,
                     batch_size=2, epochs=1, num_workers=2, print_freq=1, debug_nans=debug_nans)
        return cli.cmd_train(cfg, "cpu")

    hist = run(False, tmp_path / "plain")
    assert len(hist) == 2 and not np.isfinite(hist[0]["total"])
    with pytest.raises(RuntimeError, match="returned nan values"):
        run(True, tmp_path / "debug")
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("name", ["gwcnet-g", "gwcnet-gc", "ganet"])
def test_remat_is_refused_outside_the_dcanet_family(name):
    with pytest.raises(ValueError, match=f"model '{name}' has no remat"):
        cli.build_train_state(preset("kitti", model=name, maxdisp=16, remat=True), 4, "cpu")
    with pytest.raises(ValueError, match=f"model '{name}' has no remat"):
        tregistry.make_model(name, remat=True)
    state = cli.build_train_state(preset("kitti", model=name, maxdisp=16), 4, "cpu")
    assert not hasattr(state.model, "remat")
