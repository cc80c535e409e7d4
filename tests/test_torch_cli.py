"""The port's serving entry point and its data layer, on the CPU.

- `cli infer --device cpu` with and without `--submission`, against the
  same model called directly;
- without `--device cpu` and with no GPU, `infer` raises before any work;
- the numpy/zlib PNG reader and writer against PIL, for every filter type;
- the submission and padding protocol against dcanet_tpu.data;
- the reference-checkpoint loader, and `infer --logdir` / `load_weights`
  on the checkpoints of the port's own `cli train`.
"""

import functools
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dcanet_tpu.data import io as jio
from dcanet_tpu.data import loader as jloader
from dcanet_tpu.data import submission as jsub
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.data import io as tio
from dcanet_tpu_torch.data import submission as tsub

torch.set_num_threads(2)

MAXDISP, NUM_CVA, MODEL = 32, 1, "dcanet-cva1"


def _stereo_png_pair(tmp_path, rng, h, w):
    img = rng.integers(0, 256, size=(h, w + 8, 3), dtype=np.uint8)
    paths = tmp_path / "left.png", tmp_path / "right.png"
    Image.fromarray(img[:, 8:]).save(paths[0])
    Image.fromarray(img[:, :w]).save(paths[1])
    return paths


def _direct(model, left, right):
    tl, tr = (torch.from_numpy(x.transpose(2, 0, 1)[None].copy()) for x in (left, right))
    with torch.inference_mode():
        return model(tl, tr).disparity[0].numpy()


def _kitti_png(disp):
    return np.clip(disp * 256.0, 0, 65535).astype(np.uint16)


def test_infer_cpu_with_flax_weights(tmp_path, rng):
    lp, rp = _stereo_png_pair(tmp_path, rng, 40, 72)
    seeded = cli.build_model(MODEL, MAXDISP, device="cpu", seed=3)
    npz = tmp_path / "weights.npz"
    np.savez(npz, **W.to_jax_variables(seeded.state_dict(), NUM_CVA))
    out = tmp_path / "disp.png"
    cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--weights", str(npz),
              "--maxdisp", str(MAXDISP), "--model", MODEL, "--device", "cpu"])

    left, pads = tsub.pad_to_multiple(tio.normalize_imagenet(tio.read_image(lp)), 16)
    right, _ = tsub.pad_to_multiple(tio.normalize_imagenet(tio.read_image(rp)), 16)
    want = _kitti_png(tsub.unpad(_direct(seeded, left, right), pads))
    with Image.open(out) as im:
        got = np.asarray(im)
    assert got.shape == (40, 72)
    np.testing.assert_array_equal(got, want)


def test_infer_cpu_submission(tmp_path, rng, monkeypatch, capsys):
    """--submission at a 64x128 canvas (the 384x1248 canvas runs on the card)."""
    for name in ("to_submission_shape", "from_submission_shape"):
        monkeypatch.setattr(cli, name, functools.partial(getattr(tsub, name), crop_h=64, crop_w=128))
    lp, rp = _stereo_png_pair(tmp_path, rng, 50, 100)
    out = tmp_path / "disp.png"
    cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--submission",
              "--maxdisp", str(MAXDISP), "--model", MODEL, "--device", "cpu"])
    assert "full inference time = " in capsys.readouterr().out

    model = cli.build_model(MODEL, MAXDISP, device="cpu")  # the CLI's init seed, 0
    left, hw = tsub.to_submission_shape(tsub.whiten_per_channel(tio.read_image(lp)), 64, 128)
    right, _ = tsub.to_submission_shape(tsub.whiten_per_channel(tio.read_image(rp)), 64, 128)
    want = _kitti_png(tsub.from_submission_shape(_direct(model, left, right), hw, 64, 128))
    got = tio.read_png(out)
    assert got.shape == (50, 100) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_infer_without_gpu_raises(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lp, rp = _stereo_png_pair(tmp_path, rng, 16, 32)
    out = tmp_path / "disp.png"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.build_model(MODEL, MAXDISP)
    assert not out.exists()


def test_reference_checkpoint_loader(tmp_path):
    """torch.save({'state_dict': ...}) with `module.` keys, num_batches_tracked
    and the stride-2 ResidualBlock's `norm3` alias loads strictly."""
    model = cli.build_model(MODEL, MAXDISP, device="cpu", seed=7)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    for k in list(sd):
        if ".guidance.layer2.0.downsample.1." in k:
            sd[k.replace("downsample.1", "norm3")] = sd[k]
    path = tmp_path / "ref.tar"
    torch.save({"epoch": 3, "state_dict": sd}, path)
    loaded = W.load_weights(path, NUM_CVA)
    assert not any("num_batches_tracked" in k or "norm3" in k for k in loaded)
    fresh = cli.build_model(MODEL, MAXDISP, weights=str(path), device="cpu")
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


# ---- PNG codec ----

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(img, depth, color):
    """A PNG whose row y uses filter type y % 5 (forward filters in numpy)."""
    h = img.shape[0]
    raw = (img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8).astype(np.int64)
    bpp = raw.shape[1] // img.shape[1]
    rows = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        ftype = y % 5
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][ftype]
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


_CASES = {  # name: (shape, dtype, depth, color type)
    "gray8": ((11, 13), np.uint8, 8, 0),
    "gray_alpha8": ((11, 13, 2), np.uint8, 8, 4),
    "rgb8": ((11, 13, 3), np.uint8, 8, 2),
    "rgba8": ((11, 13, 4), np.uint8, 8, 6),
    "gray16": ((11, 13), np.uint16, 16, 0),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_png_reader_every_filter_type(tmp_path, rng, case):
    shape, dtype, depth, color = _CASES[case]
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, depth, color))
    np.testing.assert_array_equal(tio.read_png(path), img)
    with Image.open(path) as im:
        if case != "gray16":  # PIL widens 16-bit gray to int32
            np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("case", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_roundtrip_against_pil(tmp_path, rng, case):
    shape, dtype, _, _ = _CASES[case]
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    ours, theirs = tmp_path / "ours.png", tmp_path / "pil.png"
    tio.write_png(ours, img)
    with Image.open(ours) as im:
        np.testing.assert_array_equal(np.asarray(im).astype(dtype), img)
    Image.fromarray(img).save(theirs)
    np.testing.assert_array_equal(tio.read_png(theirs), img)


def test_read_image_matches_pil_rgb(tmp_path, rng):
    img = rng.integers(0, 256, size=(9, 14, 4), dtype=np.uint8)
    path = tmp_path / "rgba.png"
    Image.fromarray(img).save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"), np.float32)
    np.testing.assert_array_equal(tio.read_image(path), want)


def test_kitti_submission_png_matches_jax_writer(tmp_path, rng):
    disp = rng.uniform(-1, 300, (7, 9)).astype(np.float32)
    ours, theirs = tmp_path / "ours.png", tmp_path / "jax.png"
    tio.write_kitti_submission_png(ours, disp)
    jio.write_kitti_submission_png(theirs, disp)
    with Image.open(theirs) as im:
        np.testing.assert_array_equal(tio.read_png(ours), np.asarray(im).astype(np.uint16))


# ---- submission / padding protocol ----

@pytest.mark.parametrize("hw", [(375, 1242), (400, 1300), (370, 1226)])
def test_submission_protocol_matches_jax(rng, hw):
    img = rng.uniform(0, 255, hw + (3,)).astype(np.float32)
    np.testing.assert_allclose(tsub.whiten_per_channel(img), jsub.whiten_per_channel(img), rtol=0, atol=0)
    got, got_hw = tsub.to_submission_shape(img)
    want, want_hw = jsub.to_submission_shape(img)
    assert got_hw == want_hw
    np.testing.assert_array_equal(got, want)
    disp = rng.uniform(0, 100, (384, 1248)).astype(np.float32)
    np.testing.assert_array_equal(tsub.from_submission_shape(disp, hw), jsub.from_submission_shape(disp, hw))


@pytest.mark.parametrize("hw", [(40, 72), (48, 80), (33, 17)])
def test_pad_to_multiple_matches_jax(rng, hw):
    img = rng.uniform(0, 255, hw + (3,)).astype(np.float32)
    got, pads = tsub.pad_to_multiple(tio.normalize_imagenet(img), 16)
    want, want_pads = jloader.pad_to_multiple(jio.normalize_imagenet(img), 16)
    assert pads == want_pads
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsub.unpad(got[..., 0], pads), jloader.unpad(want[..., 0], want_pads))


# ---- cli train ----

def _tiny_sceneflow(tmp_path, monkeypatch):
    """Four 48x96 synthetic SceneFlow pairs, and the preset's crop cut to
    32x64 so that a CPU step takes a second (the 256x512 crop runs on the card)."""
    from dcanet_tpu_torch.data import datasets
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    monkeypatch.setitem(datasets.PRESETS, "sceneflow", dict(datasets.PRESETS["sceneflow"], crop=(32, 64)))
    return write_sceneflow_tree(tmp_path / "sceneflow", 4, (48, 96), seed=0, max_disp=24)


def _train_args(root, logdir):
    return ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir),
            "--maxdisp", "32", "--batch-size", "2", "--num-workers", "2", "--print-freq", "1",
            "--seed", "3", "--device", "cpu"]


def test_train_cpu_then_resume(tmp_path, monkeypatch, capsys):
    """`cli train --device cpu`: two steps, a checkpoint, the JAX CLI's
    print lines; `--resume` continues at the saved step with the saved
    optimizer state."""
    root = _tiny_sceneflow(tmp_path, monkeypatch)
    logdir = tmp_path / "run"
    args = _train_args(root, logdir)
    hist = cli.main(args + ["--epochs", "1"])
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r[k]) for r in hist for k in ("total", "focal", "smooth_l1", "grad_norm", "epe"))
    out = capsys.readouterr().out
    assert "train samples: 4" in out and "epoch 0 step 2/2 loss " in out and " pairs/s)" in out
    assert sorted(p.name for p in (logdir / "ckpt").iterdir()) == ["ckpt_00000002.pt"]
    assert len((logdir / "train_log.jsonl").read_text().splitlines()) == 2

    resumed = cli.main(args + ["--epochs", "2", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in resumed] == [2, 3]
    assert sorted(p.name for p in (logdir / "ckpt").iterdir()) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]
    payload = torch.load(logdir / "ckpt" / "ckpt_00000004.pt", weights_only=True)
    assert payload["step"] == 4 and payload["optimizer"]["state"]


def test_train_loadckpt_starts_from_saved_weights(tmp_path, monkeypatch, capsys):
    from dcanet_tpu_torch.train.checkpoint import save_params_only

    root = _tiny_sceneflow(tmp_path, monkeypatch)
    model = cli.build_model("dcanet", 32, device="cpu", seed=5)
    save_params_only(tmp_path / "w.pt", model)
    cli.main(["train", "--data-root", str(root), "--logdir", str(tmp_path / "run"), "--maxdisp", "32",
              "--epochs", "0", "--loadckpt", str(tmp_path / "w.pt"), "--device", "cpu"])
    assert f"loaded pretrained weights from {tmp_path / 'w.pt'}" in capsys.readouterr().out


def test_train_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = _tiny_sceneflow(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--data-root", str(root), "--logdir", str(tmp_path / "run"), "--maxdisp", "32"])
    assert not (tmp_path / "run" / "ckpt").exists()


# ---- infer from the checkpoints of cli train ----

def _infer_args(lp, rp, out, *extra):
    return ["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--maxdisp", "32",
            "--device", "cpu", *extra]


def test_infer_logdir_serves_train_checkpoint(tmp_path, rng, monkeypatch, capsys):
    """`infer --logdir` after `cli train` restores the newest checkpoint's
    weights: the PNG of a model loaded straight from its "model", not the
    PNG of the seed-0 init."""
    from dcanet_tpu_torch.models import DCANet

    root = _tiny_sceneflow(tmp_path, monkeypatch)
    logdir = tmp_path / "run"
    cli.main(_train_args(root, logdir) + ["--epochs", "1"])
    capsys.readouterr()
    lp, rp = _stereo_png_pair(tmp_path, rng, 40, 72)
    out, init_out = tmp_path / "disp.png", tmp_path / "init.png"
    cli.main(_infer_args(lp, rp, out, "--logdir", str(logdir)))
    ckpt = logdir / "ckpt" / "ckpt_00000002.pt"
    assert f"restored weights from {ckpt}" in capsys.readouterr().out
    cli.main(_infer_args(lp, rp, init_out))

    model = DCANet(maxdisp=32, num_cva=3)
    model.load_state_dict(torch.load(ckpt, weights_only=True)["model"], strict=True)
    left, pads = tsub.pad_to_multiple(tio.normalize_imagenet(tio.read_image(lp)), 16)
    right, _ = tsub.pad_to_multiple(tio.normalize_imagenet(tio.read_image(rp)), 16)
    want = _kitti_png(tsub.unpad(_direct(model.eval(), left, right), pads))
    got = tio.read_png(out)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, tio.read_png(init_out))


def test_load_weights_takes_train_checkpoint(tmp_path):
    """A CheckpointManager file gives exactly the model's state_dict."""
    from dcanet_tpu_torch.train.checkpoint import CheckpointManager
    from dcanet_tpu_torch.train.state import create_train_state

    model = cli.build_model("dcanet", MAXDISP, device="cpu", seed=4)
    state = create_train_state(model, lambda step: 1e-3)
    mgr = CheckpointManager(tmp_path / "ckpt")
    loaded = W.load_weights(mgr.directory / f"ckpt_{mgr.save(state):08d}.pt", 3)
    assert list(loaded) == list(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_infer_weights_and_logdir_exclude_each_other(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_infer_args("l.png", "r.png", tmp_path / "d.png", "--weights", "w.npz", "--logdir", str(tmp_path)))
    assert exc.value.code == 2
    assert "not allowed with argument" in capsys.readouterr().err


def test_infer_logdir_missing_creates_nothing(tmp_path, rng, capsys):
    """No checkpoint under --logdir: the seed-0 init, and no directory made."""
    lp, rp = _stereo_png_pair(tmp_path, rng, 16, 32)
    missing = tmp_path / "no_run"
    out, init_out = tmp_path / "disp.png", tmp_path / "init.png"
    cli.main(_infer_args(lp, rp, out, "--model", MODEL, "--logdir", str(missing)))
    assert "using the reference init from seed 0" in capsys.readouterr().out
    assert not missing.exists()
    cli.main(_infer_args(lp, rp, init_out, "--model", MODEL))
    np.testing.assert_array_equal(tio.read_png(out), tio.read_png(init_out))
