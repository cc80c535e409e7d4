"""`cli train --preset middlebury|eth3d` and `cli eval --preset middlebury`
of the port against the JAX package's `cmd_train` and `cmd_eval`, on the
CPU, on procedural trees (`write_procedural_middlebury_tree`,
`write_procedural_eth3d_tree`).

- `cmd_train`, both presets, `dcanet-cva1` at the presets' maxdisp scaled
  to the test (Middlebury 240 -> 48, ETH3D 192 -> 32), the crop cut to
  32x64 in both packages, batch 1, 3 scenes, one epoch, a row every step;
  the JAX command from the port's initial weights (`cli.build_train_state`
  at the same seed, carried by `weights.to_jax_variables`, taken by the JAX
  `create_train_state` in place of the model's eager `init`): the same
  `train/` keys at the same steps in `metrics.jsonl`, every value finite,
  the first row (the first step: same weights, same batch through the
  preset's transform, Middlebury halved) at tests/test_torch_train_step.py's
  tolerances (loss terms rtol 1e-4, EPE atol 2e-2; the grad norm is held
  against the JAX float64 gradient in tests/test_torch_middlebury_train.py,
  the JAX f32 one straying up to 1.6e-3 from it); the port's first step
  finds the smooth_l1 loss at the run's maxdisp, on the dense gt.
- `cmd_eval --preset middlebury` on two scenes of different odd sizes
  (halved 47x99 and 51x107, both replicate-padded to 64x128), maxdisp 48,
  from one checkpoint with random BatchNorm statistics, against the JAX
  `cmd_eval` with the same weights, as tests/test_torch_eval.py holds the
  KITTI one: EPE within 5e-3 px, D1 and >1/2/3 px within 1e-3, each pair's
  confusion within 1 % of its total in L1, the scores within 1e-2.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from chip_smoke import first_step_probe
from dcanet_tpu import cli as jcli
from dcanet_tpu.config import preset as jpreset
from dcanet_tpu.data import datasets as jds
from dcanet_tpu.train import metrics as jmetrics
from dcanet_tpu.train import state as jstate
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.config import preset
from dcanet_tpu_torch.data import datasets as tds
from dcanet_tpu_torch.data.synthetic import write_procedural_eth3d_tree, write_procedural_middlebury_tree
from dcanet_tpu_torch.train import metrics as tmetrics
from test_torch_eval import _random_weights, _record_confusions

torch.set_num_threads(2)

MODEL, CROP, SEED = "dcanet-cva1", (32, 64), 3
# preset -> (maxdisp, full-resolution scene size, disparity range)
TRAIN = {"eth3d": (32, (48, 96), (2.0, 40.0)), "middlebury": (48, (90, 170), (8.0, 136.0))}
EVAL_MAXDISP, EVAL_HW = 48, ((94, 198), (102, 214))  # halved: 47x99 and 51x107
SCENES = 3


def _rows(logdir):
    return [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]


def _seed_jax_init(mp, flat):
    """Make the JAX `cmd_train` and `cmd_eval` start from the flat variables
    `flat`: their `_make_state` builds the model, the schedule and Adam as
    it does, and `create_train_state` takes `flat` where it would run the
    model's `init` (eagerly, one XLA compile per op: about a minute on the
    CPU), with Adam's state from `flat` as it would be from the init's."""
    variables = unflatten_dict({k: jnp.asarray(v, jnp.float32) for k, v in flat.items()}, sep="/")

    def seeded(model, rng, sample_left, sample_right, tx):
        params = variables["params"]
        return jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                                 opt_state=tx.init(params), apply_fn=model.apply, tx=tx)

    mp.setattr(jstate, "create_train_state", seeded)


@pytest.fixture(scope="module", params=["middlebury", "eth3d"])
def train_runs(request, tmp_path_factory):
    name = request.param
    maxdisp, hw, drange = TRAIN[name]
    tmp = tmp_path_factory.mktemp(f"train_{name}")
    writer = write_procedural_middlebury_tree if name == "middlebury" else write_procedural_eth3d_tree
    root = writer(tmp / "tree", SCENES, hw, seed=5, workers=1, disp_range=drange)
    common = dict(data_root=str(root), maxdisp=maxdisp, batch_size=1, epochs=1, print_freq=1, num_workers=1,
                  model=MODEL, seed=SEED)
    start = cli.build_train_state(preset(name, **common), SCENES, "cpu").model.state_dict()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tds.PRESETS, name, dict(tds.PRESETS[name], crop=CROP))
        mp.setitem(jds.PRESETS, name, dict(jds.PRESETS[name], crop=CROP))
        first = []
        with first_step_probe(first):
            cli.main(["train", "--preset", name, "--data-root", str(root), "--logdir", str(tmp / "port"),
                      "--maxdisp", str(maxdisp), "--batch-size", "1", "--epochs", "1", "--print-freq", "1",
                      "--num-workers", "1", "--model", MODEL, "--seed", str(SEED), "--device", "cpu"])
        _seed_jax_init(mp, W.to_jax_variables(start, 1))
        jcli.cmd_train(jpreset(name, logdir=str(tmp / "jax"), **common))
    return dict(name=name, maxdisp=maxdisp, port=_rows(tmp / "port"), jax=_rows(tmp / "jax"), first=first[0],
                start=start)


def test_train_rows_match_jax(train_runs):
    port, want = train_runs["port"], train_runs["jax"]
    assert [r["step"] for r in port] == [r["step"] for r in want] == [1, 2, 3]
    assert [sorted(r) for r in port] == [sorted(r) for r in want]
    assert {"train/total", "train/smooth_l1", "train/epe", "train/grad_norm"} <= set(port[0])
    assert not any(k.startswith("train/focal") for k in port[0])
    assert all(np.isfinite(v) for r in port + want for v in r.values())


@pytest.mark.parametrize("key", ["train/total", "train/smooth_l1", "train/epe"])
def test_train_first_step_matches_jax(train_runs, key):
    got, want = train_runs["port"][0][key], train_runs["jax"][0][key]
    if key == "train/epe":
        assert got == pytest.approx(want, abs=2e-2)
    else:
        assert got == pytest.approx(want, rel=1e-4)


def test_train_first_step_takes_the_presets_loss(train_runs):
    first = train_runs["first"]
    cfg = first["loss_cfg"]
    assert (cfg.preset, cfg.max_disp, cfg.sparse) == ("smooth_l1", train_runs["maxdisp"], False)
    assert (first["step"], first["adam_entries"], first["lr"]) == (0, 0, pytest.approx(1e-3))
    start = train_runs["start"]
    assert all(torch.equal(first["weights"][k], start[k]) for k in start)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Both eval commands on a Middlebury tree of two scenes of different odd
    sizes, from the same weights: the port's from a checkpoint of step 5,
    the JAX package's through its state."""
    tmp = tmp_path_factory.mktemp("eval_middlebury")
    root = tmp / "tree"
    for i, hw in enumerate(EVAL_HW):  # one scene of each size, scene0000 and scene0001
        one = write_procedural_middlebury_tree(tmp / f"size{i}", 1, hw, seed=6 + i, workers=1,
                                               disp_range=TRAIN["middlebury"][2])
        root.mkdir(exist_ok=True)
        shutil.move(str(one / "scene0000"), str(root / f"scene{i:04d}"))
    sd, flat = _random_weights(seed=13)
    port_logdir = tmp / "port"
    (port_logdir / "ckpt").mkdir(parents=True)
    torch.save({"step": 5, "model": sd}, port_logdir / "ckpt" / "ckpt_00000005.pt")
    with pytest.MonkeyPatch.context() as mp:
        port_calls = _record_confusions(mp, tmetrics, torch.Tensor.numpy)
        port = cli.main(["eval", "--preset", "middlebury", "--data-root", str(root), "--model", MODEL,
                         "--maxdisp", str(EVAL_MAXDISP), "--logdir", str(port_logdir), "--device", "cpu"])
        _seed_jax_init(mp, flat)
        jax_calls = _record_confusions(mp, jmetrics, np.asarray)
        want = jcli.cmd_eval(jpreset("middlebury", data_root=str(root), maxdisp=EVAL_MAXDISP, model=MODEL,
                                     logdir=str(tmp / "jax")))
    return dict(port=port, want=want, port_calls=port_calls, jax_calls=jax_calls, root=root)


def test_eval_scenes_are_odd_and_padded_alike(eval_runs):
    ds = cli.build_dataset(preset("middlebury", data_root=str(eval_runs["root"])), training=False)
    shapes = [ds[i]["disparity"].shape for i in range(len(ds))]
    assert shapes == [(h // 2, w // 2) for h, w in EVAL_HW] and all(h % 2 and w % 2 for h, w in shapes)
    gts = [ds[i]["disparity"] for i in range(len(ds))]
    assert all((g >= EVAL_MAXDISP).any() and ((g > 0) & (g < EVAL_MAXDISP)).mean() > 0.5 for g in gts)


@pytest.mark.parametrize("key,tol", [("epe", 5e-3), ("d1", 1e-3), ("thres1", 1e-3), ("thres2", 1e-3),
                                     ("thres3", 1e-3)])
def test_eval_metrics_match_jax(eval_runs, key, tol):
    assert eval_runs["port"][key] == pytest.approx(eval_runs["want"][key], abs=tol)
    assert np.isfinite(eval_runs["port"][key])


def test_eval_confusions_match_jax(eval_runs):
    """2 pairs x 1 CVA volume, each over the padded 64x128 canvas (the gt
    zero around the scene); each pair's within 1 % of its total."""
    got, want = eval_runs["port_calls"], eval_runs["jax_calls"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (EVAL_MAXDISP // 8, EVAL_MAXDISP // 8)
        assert g.sum() == w.sum() > 0
        assert np.abs(g - w).sum() <= 0.01 * w.sum()


@pytest.mark.parametrize("key", ["pa", "mpa", "miou", "fwiou"])
def test_eval_scores_match_jax(eval_runs, key):
    port, want = eval_runs["port"], eval_runs["want"]
    assert port[f"vol1/{key}"] == pytest.approx(want[f"vol1/{key}"], abs=1e-2)
    assert port[key] == port[f"vol1/{key}"]
