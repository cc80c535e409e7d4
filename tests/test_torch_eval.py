"""The port's eval path against the JAX package, on the CPU.

- `eval_transform` for the four protocols and `pad_to_multiple(mode=
  "replicate")`: exact;
- `per_image_metrics` (atol 1e-6), `disparity_class_confusion` (exact),
  `segmentation_scores` (1e-6, absent classes too);
- the meters, the logger's rows and PNG panels, the error colormap;
- `cli eval --device cpu` on a synthetic KITTI 2015 tree (96x160, maxdisp
  32, dcanet-cva1) against the JAX `cmd_eval` with the same weights:
  EPE within 5e-3 px, D1 and >1/2/3 px within 1e-3, each volume's
  confusion within 1 % of its total in L1 and the scores within 1e-2
  (other logits may flip near-ties of the argmax);
- `infer --list` against the JAX `cmd_infer_list` (the same files, the
  disparities within 5e-3 px on average) and against single requests, and
  `export` against `infer --logdir`, bit for bit;
- the registry's names, the KITTI tree writer, the list files.
"""

import csv
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from PIL import Image

from dcanet_tpu import cli as jcli
from dcanet_tpu.config import preset as jpreset
from dcanet_tpu.data import eval_protocol as jprotocol
from dcanet_tpu.data import listfile as jlistfile
from dcanet_tpu.data import loader as jloader
from dcanet_tpu.models import registry as jregistry
from dcanet_tpu.train import metrics as jmetrics
from dcanet_tpu.utils import experiment as jexperiment
from dcanet_tpu.utils import visualization as jvis
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.data import eval_protocol as tprotocol
from dcanet_tpu_torch.data import io as tio
from dcanet_tpu_torch.data import listfile as tlistfile
from dcanet_tpu_torch.data import submission as tsub
from dcanet_tpu_torch.data.datasets import scan_kitti2015, scan_sceneflow
from dcanet_tpu_torch.data.synthetic import write_kitti2015_tree, write_sceneflow_tree
from dcanet_tpu_torch.models import DCANet
from dcanet_tpu_torch.models import registry as tregistry
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.train import metrics as tmetrics
from dcanet_tpu_torch.utils import experiment as texperiment
from dcanet_tpu_torch.utils import visualization as tvis

torch.set_num_threads(2)

MAXDISP, NUM_CVA, MODEL = 32, 1, "dcanet-cva1"
TREE_HW = (96, 160)


def _item(h, w, seed=0):
    """A sample in the JAX layout (H, W, 3) and in the port's (3, H, W)."""
    rng = np.random.default_rng(seed)
    left, right = (rng.random((h, w, 3), dtype=np.float32) for _ in range(2))
    gt = rng.random((h, w), dtype=np.float32) * 50 + 1
    jax_item = {"left": left, "right": right, "disparity": gt}
    port_item = {"left": left.transpose(2, 0, 1), "right": right.transpose(2, 0, 1), "disparity": gt}
    return jax_item, port_item


# ---- eval geometry ----

@pytest.mark.parametrize(
    "protocol,hw",
    [
        ("kitti", (375, 1242)), ("kitti", (300, 1000)), ("kitti", (370, 1230)),
        ("eth3d", (491, 939)), ("eth3d", (800, 1100)),
        ("middlebury", (497, 741)), ("middlebury", (65, 129)), ("middlebury", (33, 17)),
        ("sceneflow", (540, 960)), ("sceneflow", (33, 17)), ("generic", (40, 72)),
    ],
)
def test_eval_transform_matches_jax(protocol, hw):
    jitem, titem = _item(*hw)
    jl, jr, jgt, jpads = jprotocol.eval_transform(jitem, protocol)
    tl, tr, tgt, tpads = tprotocol.eval_transform(titem, protocol)
    assert tpads == jpads
    np.testing.assert_array_equal(tl.transpose(1, 2, 0), jl)
    np.testing.assert_array_equal(tr.transpose(1, 2, 0), jr)
    np.testing.assert_array_equal(tgt, jgt)
    assert tl.shape[-2:] == (tgt.shape[0] + tpads[0], tgt.shape[1] + tpads[1])


@pytest.mark.parametrize("hw", [(40, 72), (65, 129), (33, 17), (64, 128)])
def test_pad_to_multiple_replicate_matches_jax(rng, hw):
    img = rng.uniform(-2, 2, hw + (3,)).astype(np.float32)
    want, want_pads = jloader.pad_to_multiple(img, 64, mode="replicate")
    got, pads = tsub.pad_to_multiple(img, 64, mode="replicate")
    assert pads == want_pads
    np.testing.assert_array_equal(got, want)
    got_chw, pads_chw = tsub.pad_to_multiple(img.transpose(2, 0, 1), 64, mode="replicate", channels_first=True)
    assert pads_chw == want_pads
    np.testing.assert_array_equal(got_chw.transpose(1, 2, 0), want)
    with pytest.raises(ValueError, match="padding mode"):
        tsub.pad_to_multiple(img, 64, mode="reflect")


# ---- metrics ----

def _metric_batch(rng):
    """A normal image, one with under 10 % of its gt inside the mask, and
    one with no gt."""
    h, w = 24, 40
    gt = rng.uniform(1, 60, (3, h, w)).astype(np.float32)
    gt[0][rng.random((h, w)) < 0.3] = 0
    gt[1][rng.random((h, w)) < 0.95] = 200.0  # outside the mask below
    gt[2] = 0
    est = (gt + rng.normal(0, 3, gt.shape)).astype(np.float32)
    mask = (gt > 0) & (gt < 192)
    return est, gt, mask


def test_per_image_metrics_match_jax(rng):
    est, gt, mask = _metric_batch(rng)
    want = jmetrics.per_image_metrics(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask))
    got = tmetrics.per_image_metrics(torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(mask))
    assert set(got) == set(want)
    assert float(got["n_valid_images"]) == float(want["n_valid_images"]) == 1.0
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6), k


def test_per_image_metrics_with_no_image_kept(rng):
    est, gt, mask = _metric_batch(rng)
    got = tmetrics.per_image_metrics(*(torch.from_numpy(x[1:]) for x in (est, gt, mask)))
    assert {k: float(v) for k, v in got.items()} == dict.fromkeys(got, 0.0)


def _logits_and_gt(rng, d=6, hp=5, wp=7, scale=8):
    logits = rng.normal(0, 1, (2, d, hp, wp)).astype(np.float32)
    # blocks of classes 0..d+1: the top two lie outside the logits' d classes
    blocks = rng.uniform(0, (d + 2) * 8, (2, hp, wp))
    gt = np.kron(blocks, np.ones((scale, scale))) + rng.uniform(-2, 2, (2, hp * scale, wp * scale))
    gt = np.maximum(gt, 0).astype(np.float32)
    gt[0, :scale, :] = 0
    return logits, gt


def test_disparity_class_confusion_matches_jax(rng):
    logits, gt = _logits_and_gt(rng)
    want = np.asarray(jmetrics.disparity_class_confusion(jnp.asarray(logits), jnp.asarray(gt), 6))
    got = tmetrics.disparity_class_confusion(torch.from_numpy(logits), torch.from_numpy(gt), 6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 2 * 5 * 7  # some pixels are out of range, not clipped in
    with pytest.raises(ValueError, match="classes"):
        tmetrics.disparity_class_confusion(torch.from_numpy(logits), torch.from_numpy(gt), 5)


@pytest.mark.parametrize("case", ["dense", "absent_classes", "empty"])
def test_segmentation_scores_match_jax(rng, case):
    conf = rng.integers(0, 20, (6, 6)).astype(np.float32)
    if case == "absent_classes":
        conf[1, :] = 0  # no gt of class 1, but predicted
        conf[4, :] = conf[:, 4] = 0  # class 4 absent everywhere
    elif case == "empty":
        conf[:] = 0
    want = jmetrics.segmentation_scores(jnp.asarray(conf))
    got = tmetrics.segmentation_scores(torch.from_numpy(conf))
    assert set(got) == set(want) == {"pa", "mpa", "miou", "fwiou"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6), k


# ---- meters, logger, colormap ----

def test_average_meter_dict_matches_jax():
    updates = [({"epe": 1.5, "d1": 0.25}, 2), ({"epe": 0.5}, 1), ({"epe": 3.0, "d1": 1.0}, 0), ({"d1": 0.5}, 3)]
    got, want = texperiment.AverageMeterDict(), jexperiment.AverageMeterDict()
    for values, n in updates:
        got.update(values, n)
        want.update(values, n)
    assert got.mean() == want.mean()
    got.reset()
    want.reset()
    assert got.mean() == want.mean() == {"epe": 0.0, "d1": 0.0}


def test_metric_logger_writes_jsonl_and_csv(tmp_path):
    logger = texperiment.MetricLogger(str(tmp_path / "log"))
    logger.log(3, {"epe": 1.25, "d1": 0.5}, prefix="eval/")
    logger.log(4, {"epe": 1.0, "d1": 0.25}, prefix="eval/")
    logger.log(5, {"other": 1.0})  # other keys: JSONL only
    logger.close()
    rows = [json.loads(line) for line in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [3, 4, 5]
    assert rows[0]["eval/epe"] == 1.25 and rows[1]["eval/d1"] == 0.25 and rows[2]["other"] == 1.0
    with open(tmp_path / "log" / "metrics.csv") as f:
        table = list(csv.reader(f))
    assert table[0] == ["step", "time", "eval/epe", "eval/d1"]
    assert [r[0] for r in table[1:]] == ["3", "4"]


def test_metric_logger_with_tensorboard_requested(tmp_path):
    logger = texperiment.MetricLogger(str(tmp_path), use_tensorboard=True)
    logger.log(0, {"epe": 1.0})
    logger.log_image(0, "eval/x", np.zeros((4, 5, 3), np.float32))
    logger.close()
    assert (tmp_path / "images" / "eval_x_00000000.png").exists()


@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_log_image_png_matches_jax_logger(tmp_path, rng, dtype):
    img = rng.uniform(-0.2, 1.2, (9, 14, 3)).astype(np.float32)
    if dtype == "uint8":
        img = (img.clip(0, 1) * 255).astype(np.uint8)
    ours = texperiment.MetricLogger(str(tmp_path / "ours"))
    theirs = jexperiment.MetricLogger(str(tmp_path / "jax"))
    got_path = ours.log_image(12, "eval/sample0", img)
    want_path = theirs.log_image(12, "eval/sample0", img)
    ours.close()
    theirs.close()
    assert os.path.basename(got_path) == os.path.basename(want_path) == "eval_sample0_00000012.png"
    with Image.open(want_path) as im:
        np.testing.assert_array_equal(tio.read_png(got_path), np.asarray(im))


def test_disp_error_image_matches_jax(rng):
    gt = rng.uniform(0, 80, (30, 50)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.3] = 0
    est = (gt + rng.normal(0, 1, gt.shape) * rng.choice([0.1, 1, 10, 50], gt.shape)).astype(np.float32)
    np.testing.assert_array_equal(tvis.gen_error_colormap(), jvis.gen_error_colormap())
    np.testing.assert_array_equal(tvis.disp_error_image(est, gt), jvis.disp_error_image(est, gt))


# ---- cli eval against the JAX cmd_eval ----

def _random_weights(seed):
    """A port state_dict for dcanet-cva1 with random BatchNorm affine and
    statistics, so that no BatchNorm is the identity."""
    model = reference_init_(DCANet(maxdisp=MAXDISP, num_cva=NUM_CVA), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    flat = W.to_jax_variables(model.state_dict(), NUM_CVA)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("/bias"):
            flat[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    model.load_state_dict(W.from_jax_variables(flat, NUM_CVA), strict=True)
    return model.state_dict(), flat


def _seed_jax_state(mp, flat):
    """Make the JAX CLI's `_make_state` return the flat variables `flat`."""
    variables = unflatten_dict(flat, sep="/")
    make_state = jcli._make_state

    def seeded_state(cfg, steps_per_epoch, mesh=None):
        model, state = make_state(cfg, steps_per_epoch, mesh=mesh)
        to_jax = functools.partial(jnp.asarray, dtype=jnp.float32)
        from jax import tree

        return model, state.replace(params=tree.map(to_jax, variables["params"]),
                                    batch_stats=tree.map(to_jax, variables["batch_stats"]))

    mp.setattr(jcli, "_make_state", seeded_state)


def _record_confusions(monkeypatch, module, to_numpy):
    """Wrap module.disparity_class_confusion; returns the list of its outputs."""
    calls = []
    inner = module.disparity_class_confusion

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        calls.append(np.array(to_numpy(out)))
        return out

    monkeypatch.setattr(module, "disparity_class_confusion", wrapped)
    return calls


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Both eval commands on a 3-pair tree (two scored pairs and one that the
    skip rule drops), from the same weights: the port's from a checkpoint
    of step 7 under its logdir, the JAX package's through its state."""
    tmp = tmp_path_factory.mktemp("eval")
    root = write_kitti2015_tree(tmp / "kitti", 3, TREE_HW, seed=1, max_disp=24, out_of_range_pair=2,
                                maxdisp=MAXDISP)
    sd, flat = _random_weights(seed=11)
    port_logdir = tmp / "port"
    (port_logdir / "ckpt").mkdir(parents=True)
    torch.save({"step": 7, "model": sd}, port_logdir / "ckpt" / "ckpt_00000007.pt")

    with pytest.MonkeyPatch.context() as mp:
        port_calls = _record_confusions(mp, tmetrics, torch.Tensor.numpy)
        port = cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(root),
                         "--model", MODEL, "--maxdisp", str(MAXDISP), "--logdir", str(port_logdir),
                         "--log-images", "1", "--device", "cpu"])

        _seed_jax_state(mp, flat)
        jax_calls = _record_confusions(mp, jmetrics, np.asarray)
        cfg = jpreset("kitti", data_root=str(root), dataset="kitti2015", maxdisp=MAXDISP, model=MODEL,
                      logdir=str(tmp / "jax"), log_images=1)
        want = jcli.cmd_eval(cfg)
    return dict(port=port, want=want, port_calls=port_calls, jax_calls=jax_calls, logdir=port_logdir)


@pytest.mark.parametrize("key,tol", [("epe", 5e-3), ("d1", 1e-3), ("thres1", 1e-3), ("thres2", 1e-3),
                                     ("thres3", 1e-3)])
def test_cli_eval_metrics_match_jax(eval_runs, key, tol):
    assert eval_runs["port"][key] == pytest.approx(eval_runs["want"][key], abs=tol)
    assert np.isfinite(eval_runs["port"][key])


def test_cli_eval_confusions_match_jax(eval_runs):
    """3 pairs x 1 CVA volume; each pair's confusion within 1 % of its total."""
    got, want = eval_runs["port_calls"], eval_runs["jax_calls"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (MAXDISP // 8, MAXDISP // 8)
        assert g.sum() == w.sum() > 0
        assert np.abs(g - w).sum() <= 0.01 * w.sum()


@pytest.mark.parametrize("key", ["pa", "mpa", "miou", "fwiou"])
def test_cli_eval_scores_match_jax(eval_runs, key):
    port, want = eval_runs["port"], eval_runs["want"]
    assert port[f"vol1/{key}"] == pytest.approx(want[f"vol1/{key}"], abs=1e-2)
    assert port[key] == port[f"vol1/{key}"]


def test_cli_eval_writes_panels_and_metrics(eval_runs):
    images = eval_runs["logdir"] / "images"
    panel = tio.read_png(images / "eval_sample0_00000007.png")
    assert panel.shape == (4 * TREE_HW[0], TREE_HW[1], 3) and panel.dtype == np.uint8
    mass = tio.read_png(images / "eval_sample0_probmass_vol1_00000007.png")
    assert mass.shape == (TREE_HW[0] // 8, TREE_HW[1] // 8, 3)
    assert sorted(p.name for p in images.iterdir()) == [
        "eval_sample0_00000007.png", "eval_sample0_probmass_vol1_00000007.png"]
    rows = [json.loads(line) for line in (eval_runs["logdir"] / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["step"] == 7 and rows[0]["eval/epe"] == eval_runs["port"]["epe"]
    assert rows[0]["eval/ms_per_pair"] > 0


def test_cli_eval_seeded_init_and_vis_band(tmp_path, capsys):
    """No checkpoint: the reference init from --seed, said so; a --vis-band
    panel per volume."""
    root = write_kitti2015_tree(tmp_path / "kitti", 1, (32, 64), seed=2, max_disp=12, maxdisp=MAXDISP)
    res = cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(root),
                    "--model", "dcanet-cva2", "--maxdisp", str(MAXDISP), "--logdir", str(tmp_path / "run"),
                    "--log-images", "1", "--vis-band", "8:16", "--seed", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"no checkpoint under {tmp_path / 'run' / 'ckpt'}; using the reference init from seed 4" in out
    assert "evaluating step 0" in out
    assert {"vol1/miou", "vol2/miou", "miou"} <= set(res) and res["miou"] == res["vol2/miou"]
    assert "ms_per_pair" not in res  # one pair: no time after the first
    names = sorted(p.name for p in (tmp_path / "run" / "images").iterdir())
    assert names == [f"eval_sample0{s}_00000000.png" for s in ("", "_probmass_vol1", "_probmass_vol2")]


def test_cli_eval_sceneflow_pads_and_panels(tmp_path):
    """The SceneFlow protocol pads 40 rows to 48 on top: the metrics and the
    panel see the prediction with the pad stripped (the JAX package's panel
    unpads its (H, W, 3) input along W and C instead, and cannot be built
    with a pad: ROADMAP Queue 3)."""
    root = write_sceneflow_tree(tmp_path / "sf", 1, (40, 64), seed=3, max_disp=12, split="TEST")
    res = cli.main(["eval", "--preset", "sceneflow", "--data-root", str(root), "--model", "dcanet-cva0",
                    "--maxdisp", str(MAXDISP), "--logdir", str(tmp_path / "run"), "--log-images", "1",
                    "--device", "cpu"])
    assert np.isfinite(res["epe"]) and "pa" not in res  # no CVA volume, no class scores
    assert tio.read_png(tmp_path / "run" / "images" / "eval_sample0_00000000.png").shape == (4 * 40, 64, 3)


@pytest.mark.parametrize("spec", ["8", "a:b", "16:8", "1:2:3"])
def test_vis_band_rejects_malformed(tmp_path, spec):
    with pytest.raises(SystemExit, match="--vis-band"):
        cli.main(["eval", "--data-root", str(tmp_path), "--logdir", str(tmp_path / "run"), "--vis-band", spec,
                  "--device", "cpu"])
    assert not (tmp_path / "run").exists()


def test_eval_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = write_kitti2015_tree(tmp_path / "kitti", 1, (32, 64), max_disp=12, maxdisp=MAXDISP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(root),
                  "--logdir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


# ---- infer --list and export ----

def _submission_canvas(monkeypatch):
    """The submission protocol at a 64x128 canvas (384x1248 runs on the card),
    in the port and in the JAX package."""
    from dcanet_tpu.data import submission as jsub

    for name in ("to_submission_shape", "from_submission_shape"):
        monkeypatch.setattr(cli, name, functools.partial(getattr(tsub, name), crop_h=64, crop_w=128))
        monkeypatch.setattr(jsub, name, functools.partial(getattr(jsub, name), crop_h=64, crop_w=128))


def _single_request(root, name, out, *extra):
    cli.main(["infer", "--left", str(root / "image_2" / name), "--right", str(root / "image_3" / name),
              "--out", str(out), "--submission", "--maxdisp", str(MAXDISP), "--model", MODEL,
              "--device", "cpu", *extra])
    return tio.read_png(out)


def test_infer_list_matches_single_requests(tmp_path, monkeypatch, capsys):
    _submission_canvas(monkeypatch)
    root = write_kitti2015_tree(tmp_path / "kitti", 3, (50, 100), seed=3, max_disp=20, maxdisp=MAXDISP)
    names = ["000002_10.png", "000000_10.png"]
    (tmp_path / "test.txt").write_text("\n".join(names) + "\n\n")
    cli.main(["infer", "--list", str(tmp_path / "test.txt"), "--data-root", str(root), "--save-path",
              str(tmp_path / "sub"), "--maxdisp", str(MAXDISP), "--model", MODEL, "--device", "cpu"])
    out = capsys.readouterr().out
    assert all(f"{n}: " in out for n in names) and "full inference time = " in out
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == sorted(names)
    for name in names:
        got = tio.read_png(tmp_path / "sub" / name)
        assert got.shape == (50, 100) and got.dtype == np.uint16
        np.testing.assert_array_equal(got, _single_request(root, name, tmp_path / "one.png"))


def test_infer_list_matches_jax(tmp_path, monkeypatch, capsys):
    """The port's `infer --list` against the JAX `cmd_infer_list` on the same
    tree, list and weights: the same files, and disparities within the eval
    test's EPE tolerance (5e-3 px) on average and within two steps of the
    PNG's 1/256 px everywhere."""
    _submission_canvas(monkeypatch)
    root = write_kitti2015_tree(tmp_path / "kitti", 3, (50, 100), seed=5, max_disp=20, maxdisp=MAXDISP)
    names = ["000001_10.png", "000002_10.png"]
    lst = tmp_path / "test.txt"
    lst.write_text("\n".join(names) + "\n\n")
    sd, flat = _random_weights(seed=12)
    (tmp_path / "port" / "ckpt").mkdir(parents=True)
    torch.save({"step": 3, "model": sd}, tmp_path / "port" / "ckpt" / "ckpt_00000003.pt")
    cli.main(["infer", "--list", str(lst), "--data-root", str(root), "--save-path", str(tmp_path / "sub_port"),
              "--logdir", str(tmp_path / "port"), "--model", MODEL, "--maxdisp", str(MAXDISP), "--device", "cpu"])
    _seed_jax_state(monkeypatch, flat)
    cfg = jpreset("kitti", maxdisp=MAXDISP, model=MODEL, logdir=str(tmp_path / "jax"))
    jcli.cmd_infer_list(cfg, str(root), str(lst), str(tmp_path / "sub_jax"))
    out = capsys.readouterr().out
    assert out.count("full inference time = ") == 2
    port_files = sorted(p.name for p in (tmp_path / "sub_port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "sub_jax").iterdir()) == sorted(names)
    for name in names:
        got, want = (tio.read_png(tmp_path / d / name) for d in ("sub_port", "sub_jax"))
        assert got.shape == want.shape == (50, 100) and got.dtype == want.dtype == np.uint16
        assert np.any(want > 0)
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64)) / 256.0
        assert diff.mean() <= 5e-3 and diff.max() <= 1.0 / 128, (name, diff.mean(), diff.max())


def test_infer_needs_a_pair_or_a_list(tmp_path, capsys):
    for extra in ([], ["--left", "l.png", "--right", "r.png"], ["--list", str(tmp_path / "t.txt")]):
        with pytest.raises(SystemExit) as exc:
            cli.main(["infer", "--device", "cpu", *extra])
        assert exc.value.code == 2
    assert "--data-root" in capsys.readouterr().err


def _train_checkpoint(logdir, seed):
    from dcanet_tpu_torch.train.checkpoint import CheckpointManager
    from dcanet_tpu_torch.train.state import create_train_state

    model = DCANet(maxdisp=MAXDISP, num_cva=NUM_CVA)
    model.load_state_dict(_random_weights(seed)[0], strict=True)
    state = create_train_state(model, lambda step: 1e-3)
    state.step = 5
    return CheckpointManager(logdir / "ckpt").save(state)


def test_export_then_infer_weights_matches_logdir(tmp_path, monkeypatch, capsys):
    """export writes the newest checkpoint's weights; infer --weights on
    that file gives infer --logdir's PNG; train --loadckpt takes it."""
    from dcanet_tpu_torch.train.checkpoint import load_params_only

    _submission_canvas(monkeypatch)
    root = write_kitti2015_tree(tmp_path / "kitti", 1, (50, 100), seed=4, max_disp=20, maxdisp=MAXDISP)
    logdir = tmp_path / "run"
    _train_checkpoint(logdir, seed=6)
    export = tmp_path / "weights.pt"
    cli.main(["export", "--logdir", str(logdir), "--out", str(export)])
    assert f"exported the weights of {logdir / 'ckpt' / 'ckpt_00000005.pt'}" in capsys.readouterr().out
    name = "000000_10.png"
    got = _single_request(root, name, tmp_path / "w.png", "--weights", str(export))
    want = _single_request(root, name, tmp_path / "l.png", "--logdir", str(logdir))
    np.testing.assert_array_equal(got, want)
    init = _single_request(root, name, tmp_path / "i.png")
    assert not np.array_equal(got, init)
    model = load_params_only(export, DCANet(maxdisp=MAXDISP, num_cva=NUM_CVA))
    saved = torch.load(logdir / "ckpt" / "ckpt_00000005.pt", weights_only=True)["model"]
    for k, v in saved.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_export_without_checkpoint_raises_and_writes_nothing(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing to export"):
        cli.main(["export", "--logdir", str(tmp_path / "run"), "--out", str(tmp_path / "out" / "w.pt")])
    assert list(tmp_path.iterdir()) == []


# ---- registry ----

@pytest.mark.parametrize("name,num_cva,full_res", [
    ("dcanet", 3, False), ("dcanet-cva0", 0, False), ("dcanet-cva1", 1, False), ("dcanet-cva2", 2, False),
    ("dcanet-cva4", 4, True),
])
def test_registry_builds_dcanet_family(name, num_cva, full_res):
    model = tregistry.make_model(name, maxdisp=48, remat=True)
    assert isinstance(model, DCANet)
    assert (model.maxdisp, model.num_cva, model.full_res_supervision, model.remat) == (48, num_cva, full_res, True)
    jmodel = jregistry.make_model(name, maxdisp=48)
    assert (jmodel.num_cva, jmodel.full_res_supervision) == (num_cva, full_res)


@pytest.mark.parametrize("name", ["dcanet-g", "gwcnet-g", "gwcnet-gc", "ganet"])
def test_registry_builds_the_other_families(name):
    """The names the port added after the DCANet family: the same class and
    options as the JAX registry's model of that name."""
    from dcanet_tpu_torch.models import GANetStereo, GwcNetBaseline

    model = tregistry.make_model(name, maxdisp=48)
    jmodel = jregistry.make_model(name, maxdisp=48)
    assert type(model).__name__ == type(jmodel).__name__ and model.maxdisp == 48
    if isinstance(model, DCANet):
        assert (model.num_cva, model.use_concat_volume) == (jmodel.num_cva, jmodel.use_concat_volume) == (3, False)
    elif isinstance(model, GwcNetBaseline):
        assert model.use_concat_volume == jmodel.use_concat_volume == (name == "gwcnet-gc")
    else:
        assert isinstance(model, GANetStereo)
        assert (model.num_sga, model.lga is not None) == (jmodel.num_sga, jmodel.use_lga)


def test_registry_covers_the_jax_names():
    assert set(tregistry.MODELS) == set(jregistry.MODELS)
    with pytest.raises(KeyError, match="unknown model"):
        tregistry.make_model("gwcnet")


def test_train_state_takes_the_registry_model():
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.models import GwcNetBaseline

    state = cli.build_train_state(preset("kitti", model="dcanet-cva1", maxdisp=MAXDISP), 4, "cpu")
    assert isinstance(state.model, DCANet) and state.model.num_cva == 1
    state = cli.build_train_state(preset("kitti", model="gwcnet-gc", maxdisp=MAXDISP), 4, "cpu")
    assert isinstance(state.model, GwcNetBaseline) and state.model.use_concat_volume


# ---- synthetic trees and list files ----

def test_kitti_tree_is_consistent_and_sparse(tmp_path):
    root = write_kitti2015_tree(tmp_path / "k", 2, (80, 120), seed=5, min_disp=3, max_disp=30,
                                out_of_range_pair=1, maxdisp=MAXDISP)
    assert [os.path.basename(s.left) for s in scan_kitti2015(str(root))] == ["000000_10.png", "000001_10.png"]
    for i in range(2):
        name = f"{i:06d}_10.png"
        left = tio.read_image(root / "image_2" / name)
        right = tio.read_image(root / "image_3" / name)
        gt = tio.read_disparity(root / "disp_occ_0" / name)
        assert tio.read_png(root / "disp_occ_0" / name).dtype == np.uint16
        valid = gt > 0
        assert not valid[:20].any() and 0.3 < valid[20:].mean() < 0.5
        for y in range(20, 80):
            d = np.unique(gt[y][valid[y]])
            assert len(d) == 1
            np.testing.assert_array_equal(left[y, int(d[0]):], right[y, : 120 - int(d[0])])
        inside = ((gt > 0) & (gt < MAXDISP)).mean() / valid.mean()
        assert (inside < 0.1) if i == 1 else (inside == 1.0)
    with pytest.raises(ValueError, match="below 256"):
        write_kitti2015_tree(tmp_path / "bad", 1, (8, 8), maxdisp=256)


def test_sceneflow_test_split_is_the_eval_split(tmp_path):
    root = write_sceneflow_tree(tmp_path / "sf", 2, (16, 32), seed=1, max_disp=8)
    write_sceneflow_tree(root, 3, (16, 32), seed=2, max_disp=8, split="TEST")
    train, test = scan_sceneflow(str(root))
    assert len(train) == 2 and len(test) == 3
    assert all("/TEST/" in s.left for s in test)


def test_list_file_matches_jax(tmp_path):
    (tmp_path / "list.txt").write_text("a/l.png a/r.png a/d.pfm\n\nb/l.png b/r.png\n")
    got = tlistfile.read_list_file(str(tmp_path / "list.txt"), "/data")
    want = jlistfile.read_list_file(str(tmp_path / "list.txt"), "/data")
    assert [(s.left, s.right, s.disparity) for s in got] == [(s.left, s.right, s.disparity) for s in want]
    ds = tlistfile.__datasets__["kitti"](str(tmp_path / "list.txt"), "/data", False)
    assert ds.preset == "kitti" and len(ds) == 2 and not ds.training
