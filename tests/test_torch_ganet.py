"""The GANet family of the port against the JAX package, on the CPU: the
SGA / LGA ops (value and gradient against jax.grad), `my_normalize`, the
SGA and LGA blocks, GANet's two losses with their custom backwards, the
GANetStereo eval and train forwards, one train step, and `cli infer
--model ganet`.

Weights are drawn on the port's side and carried to flax through
`weights.to_jax_variables` (as in tests/test_torch_gwcnet.py), and
`weights.ganet_table` is held against the flax model's own variable tree.
Inputs 1x3x32x64, maxdisp 16; the JAX side runs eagerly.

Tolerances: ops and blocks in float32, summed in another order: atol 1e-5
after scaling by max(|x|, 1) (gradients 1e-4); the losses' values 1e-5
relative (a float32 mean of 768 terms in another order), their gradients
1e-6;
the model as tests/test_torch_gwcnet.py: eval disparity 5e-3 px, train
disparities 2e-2, the final cost logits 1e-4 scaled, BatchNorm statistics
1e-3 scaled, one train step's loss rtol 1e-4 and grad norm rtol 1e-3.

The JAX package's SGA scans with `lax.scan(..., unroll=8)`
(dcanet_tpu/ops/sga.py:74), and with jax 0.9.0 on the CPU the reverse-mode
derivative of that scan is wrong: it disagrees with the scan's own jvp and
with finite differences of its forward (`test_sga_gradient_matches_finite_
differences`), while unroll=1 agrees with both. Gradients of the JAX side
are therefore taken with `lax.scan` at unroll=1 (the `scan_unroll_1`
fixture), the same function; ROADMAP Queue 3 logs the fault.
"""

import functools

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dcanet_tpu import losses as jlosses
from dcanet_tpu.models import GANetStereo as FlaxGANetStereo
from dcanet_tpu.models import registry as jregistry
from dcanet_tpu.nn import ganet as jganet
from dcanet_tpu.ops import sga as jsga
from dcanet_tpu_torch import cli
from dcanet_tpu_torch import losses as tlosses
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.models import DCANetEvalOutput, DCANetTrainOutput, GANetStereo
from dcanet_tpu_torch.models import registry as tregistry
from dcanet_tpu_torch.nn import ganet as tganet
from dcanet_tpu_torch.nn.layers import reference_init_
from dcanet_tpu_torch.ops import sga as tsga
from test_torch_gwcnet import (
    H, Wd, flax_head, head_output, images, nchw, one_train_step, port_and_flat, randomize, scaled_close,
)

torch.set_num_threads(2)

MAXDISP = 16


@pytest.fixture
def scan_unroll_1(monkeypatch):
    """jax.lax.scan at unroll=1, whatever its caller asks (see the module doc)."""
    monkeypatch.setattr(jax.lax, "scan", functools.partial(_scan_unroll_1, jax.lax.scan))


def _scan_unroll_1(scan, *args, **kw):
    return scan(*args, **{**kw, "unroll": 1})


def _grads_close(got, want, atol=1e-4):
    for g, w in zip(got, want):
        scaled_close(g.numpy(), np.asarray(w), atol=atol)


# ---- ops ----

def _sga_inputs(seed, normalize, b=1, c=2, d=5, h=6, w=7):
    """A cost (B, C, D, H, W) and normalised weights (B, 4, 5, H, W), and the
    cotangent of the output."""
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal((b, c, d, h, w)).astype(np.float32)
    logits = rng.standard_normal((b, 4, 5, h, w)).astype(np.float32)
    weights = tganet.my_normalize(torch.from_numpy(logits), 2) if normalize == "l1" else \
        torch.from_numpy(logits).softmax(dim=2)
    cot = rng.standard_normal(cost.shape).astype(np.float32)
    return cost, weights.numpy(), cot


def _jax_sga(cost, weights):
    """The JAX op vmapped over C, in the port's layouts."""
    wj = jnp.transpose(weights, (0, 3, 4, 1, 2))  # (B, H, W, 4, 5)
    return jax.vmap(lambda vol: jsga.sga_aggregate(vol, wj), in_axes=1, out_axes=1)(cost)


@pytest.mark.parametrize("normalize", ["softmax", "l1"])
def test_sga_aggregate_matches_jax(normalize, scan_unroll_1):
    cost, weights, cot = _sga_inputs(0, normalize)
    want, vjp = jax.vjp(_jax_sga, jnp.asarray(cost), jnp.asarray(weights))
    tc, tw = (torch.from_numpy(x).requires_grad_() for x in (cost, weights))
    got = tsga.sga_aggregate(tc, tw)
    scaled_close(got.detach().numpy(), np.asarray(want), atol=1e-5)
    _grads_close(torch.autograd.grad(got, (tc, tw), torch.from_numpy(cot)), vjp(jnp.asarray(cot)))


def test_sga_gradient_matches_finite_differences():
    """The port's gradient against central differences (float64) of the JAX
    package's forward as it stands (unroll=8), which no JAX derivative enters."""
    cost, weights, cot = _sga_inputs(9, "softmax", c=1, d=3, h=4, w=5)
    with jax.enable_x64(True):
        w64, cot64 = jnp.asarray(weights, jnp.float64), jnp.asarray(cot, jnp.float64)
        f = jax.jit(lambda c: jnp.vdot(_jax_sga(c, w64), cot64))
        c64, eps = cost.astype(np.float64), 1e-6
        fd = np.zeros_like(c64)
        for idx in np.ndindex(c64.shape):
            hi, lo = c64.copy(), c64.copy()
            hi[idx] += eps
            lo[idx] -= eps
            fd[idx] = (float(f(hi)) - float(f(lo))) / (2 * eps)
    tc = torch.from_numpy(cost).requires_grad_()
    got = torch.autograd.grad(tsga.sga_aggregate(tc, torch.from_numpy(weights)), tc, torch.from_numpy(cot))[0]
    scaled_close(got.numpy(), fd, atol=1e-5)


def test_sga_aggregate_boundaries():
    """One line, one disparity: each direction reduces to w0 * cost at its
    first step; a unit w0 returns the cost; bf16 in, bf16 out, f32 inside."""
    cost, _, _ = _sga_inputs(1, "softmax", h=1, w=1, d=1)
    w = torch.zeros(1, 4, 5, 1, 1)
    w[:, :, 0] = 1.0
    np.testing.assert_array_equal(tsga.sga_aggregate(torch.from_numpy(cost), w).numpy(), cost)
    cost, weights, _ = _sga_inputs(2, "softmax")
    got = tsga.sga_aggregate(torch.from_numpy(cost).bfloat16(), torch.from_numpy(weights))
    want = tsga.sga_aggregate(torch.from_numpy(cost).bfloat16().float(), torch.from_numpy(weights))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)
    with pytest.raises(ValueError, match="do not fit"):
        tsga.sga_aggregate(torch.from_numpy(cost), torch.from_numpy(weights)[..., :-1])


def test_lga3d_matches_jax():
    rng = np.random.default_rng(3)
    b, c, d, h, w, r = 1, 2, 5, 6, 7, 2
    cost = rng.standard_normal((b, c, d, h, w)).astype(np.float32)
    filt = rng.standard_normal((b, 3, (2 * r + 1) ** 2, h, w)).astype(np.float32)
    cot = rng.standard_normal(cost.shape).astype(np.float32)

    def jax_lga(cost, filt):
        fj = jnp.transpose(filt, (0, 3, 4, 1, 2))  # (B, H, W, 3, K2)
        return jax.vmap(lambda vol: jsga.lga3d(vol, fj, r), in_axes=1, out_axes=1)(cost)

    want, vjp = jax.vjp(jax_lga, jnp.asarray(cost), jnp.asarray(filt))
    tc, tf = (torch.from_numpy(x).requires_grad_() for x in (cost, filt))
    got = tsga.lga3d(tc, tf, r)
    scaled_close(got.detach().numpy(), np.asarray(want), atol=1e-5)
    _grads_close(torch.autograd.grad(got, (tc, tf), torch.from_numpy(cot)), vjp(jnp.asarray(cot)))


def test_my_normalize_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 4, 5)).astype(np.float32)
    x[1, 2] = 0.0  # a zero norm: the guard turns negative
    want = np.asarray(jganet.my_normalize(jnp.asarray(x)))
    got = tganet.my_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tganet.my_normalize(torch.from_numpy(x.transpose(0, 2, 1)), dim=1).numpy(),
                               want.transpose(0, 2, 1), rtol=1e-6, atol=0)


# ---- blocks ----

BLOCKS = {  # case: (port block, flax block)
    "sga softmax": (lambda: tganet.SGABlock(6, hidden=8), lambda: jganet.SGABlock(hidden=8)),
    "sga l1": (lambda: tganet.SGABlock(6, hidden=8, normalize="l1"),
               lambda: jganet.SGABlock(hidden=8, normalize="l1")),
    "lga": (lambda: tganet.LGABlock(6, hidden=8), lambda: jganet.LGABlock(hidden=8)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_guided_block_matches_flax(case, train):
    make_port, make_flax = BLOCKS[case]
    block = reference_init_(make_port(), torch.Generator().manual_seed(5))
    table = W.guided_block_table("", "")
    flat = randomize(W.flax_from_state_dict(block.state_dict(), table), 5)
    block.load_state_dict(W.state_dict_from_flax(flat, table), strict=True)
    block.train(train)
    rng = np.random.default_rng(6)
    cost = rng.standard_normal((1, 3, 4, 6, 10)).astype(np.float32)
    guide = rng.standard_normal((1, 6, 6, 10)).astype(np.float32)
    args = (jnp.asarray(cost.transpose(0, 2, 3, 4, 1)), jnp.asarray(guide.transpose(0, 2, 3, 1)), train)
    if train:
        want, upd = make_flax().apply(unflatten_dict(flat, sep="/"), *args, mutable=["batch_stats"])
    else:
        want = make_flax().apply(unflatten_dict(flat, sep="/"), *args)
    with torch.no_grad():
        got = block(torch.from_numpy(cost), torch.from_numpy(guide))
    scaled_close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3), atol=1e-5)
    if train:
        stats = W.flax_from_state_dict(block.state_dict(), table)
        for k, v in flatten_dict(upd["batch_stats"], sep="/").items():
            scaled_close(stats[f"batch_stats/{k}"], np.asarray(v), atol=1e-5)


def test_sga_block_rejects_unknown_normalisation():
    with pytest.raises(ValueError, match="normalize"):
        tganet.SGABlock(normalize="l2")


# ---- losses ----

LOSSES = {
    "ganet_loss": (tlosses.ganet_loss, jlosses.ganet_loss, (5.0, 1.0)),
    "ganet_loss2": (tlosses.ganet_loss2, jlosses.ganet_loss2, (1.0, 2.0)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_ganet_losses_match_jax(name):
    """Value and the custom gradient, with |pred - target| over every branch
    of both backwards (0 to 8 px, both signs)."""
    tfn, jfn, params = LOSSES[name]
    rng = np.random.default_rng(7)
    target = rng.uniform(0, 40, (2, 16, 24)).astype(np.float32)
    pred = (target + rng.uniform(-8, 8, target.shape)).astype(np.float32)
    want, (gp, gt) = jax.value_and_grad(lambda p, t: jfn(p, t, *params), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target))
    tp, tt = (torch.from_numpy(x).requires_grad_() for x in (pred, target))
    got = tfn(tp, tt, *params)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    dp, dt = torch.autograd.grad(3.0 * got, (tp, tt))
    np.testing.assert_allclose(dp.numpy(), 3.0 * np.asarray(gp), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dt.numpy(), 3.0 * np.asarray(gt), rtol=1e-6, atol=1e-9)
    # the custom backward is not the forward's gradient
    assert not np.allclose(dp.numpy(), np.sign(pred - target) / pred.size)


# ---- the model ----

def test_ganet_table_covers_the_flax_variables():
    left, right = images(0)
    for kw in ({}, {"num_sga": 1, "use_lga": False}):
        fmodel = FlaxGANetStereo(maxdisp=MAXDISP, **kw)
        shapes = jax.eval_shape(lambda: fmodel.init(jax.random.PRNGKey(0), left, right, train=True))
        want = {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
        model = GANetStereo(maxdisp=MAXDISP, **kw)
        got = W.to_jax_variables(model.state_dict(), model)
        assert {k: v.shape for k, v in got.items()} == want
        assert W.model_table(model) == W.ganet_table(**kw)
    assert W.model_table("ganet") == W.ganet_table()


VARIANTS = {  # case: GANetStereo options
    "ganet": {},
    "sga1 l1 concat-only no-lga": dict(num_sga=1, use_lga=False, use_gwc_volume=False, sga_normalize="l1"),
}


@pytest.fixture(scope="module")
def forwards():
    left, right = images(1)
    results = {}
    for seed, (case, kw) in enumerate(sorted(VARIANTS.items()), start=30):
        model = reference_init_(GANetStereo(maxdisp=MAXDISP, **kw), torch.Generator().manual_seed(seed))
        flat = randomize(W.to_jax_variables(model.state_dict(), model), seed)
        model.load_state_dict(W.from_jax_variables(flat, model), strict=True)
        fmodel = FlaxGANetStereo(maxdisp=MAXDISP, **kw)
        variables = unflatten_dict(flat, sep="/")
        fev, fstate = fmodel.apply(variables, left, right, train=False, mutable=["intermediates"],
                                   capture_intermediates=lambda mdl, _: mdl.name == "classif_final")
        with torch.no_grad():
            tev, thead = head_output(model.eval(), "classif_final", lambda: model(nchw(left), nchw(right)))
        r = dict(fev=fev, fhead=flax_head(fstate, "classif_final"), tev=tev, thead=thead)
        if case == "ganet":
            r["ftr"], upd = fmodel.apply(variables, left, right, train=True, mutable=["batch_stats"])
            r["fstats"] = upd["batch_stats"]
            r["tmodel"] = copy.deepcopy(model).train()
            with torch.no_grad():
                r["ttr"] = r["tmodel"](nchw(left), nchw(right))
        results[case] = r
    return results


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_eval_forward_matches_flax(forwards, case):
    r = forwards[case]
    assert isinstance(r["tev"], DCANetEvalOutput) and r["tev"].class_logits == ()
    got = r["tev"].disparity
    assert got.shape == (1, H, Wd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(r["fev"].disparity), atol=5e-3, rtol=0)
    scaled_close(r["thead"].numpy(), r["fhead"], atol=1e-4)


def test_train_forward_matches_flax(forwards):
    r = forwards["ganet"]
    got, want = r["ttr"], r["ftr"]
    assert isinstance(got, DCANetTrainOutput)
    assert (len(got.prob_volumes), len(got.disparities), len(got.class_logits)) == (0, 3, 0)
    assert len(want.disparities) == 3
    for g, w in zip(got.disparities, want.disparities):
        assert g.shape == (1, H, Wd) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2, rtol=0)
    stats = W.to_jax_variables(r["tmodel"].state_dict(), r["tmodel"])
    for k, v in flatten_dict(r["fstats"], sep="/").items():
        scaled_close(stats[f"batch_stats/{k}"], np.asarray(v), atol=1e-3)


def test_train_step_matches_jax_ganet(scan_unroll_1):
    fmetrics, tmetrics = one_train_step("ganet", MAXDISP, seed=41)
    for key, rel in (("total", 1e-4), ("smooth_l1", 1e-4), ("grad_norm", 1e-3)):
        assert float(tmetrics[key]) == pytest.approx(float(fmetrics[key]), rel=rel), key
    assert float(tmetrics["epe"]) == pytest.approx(float(fmetrics["epe"]), abs=2e-2)


def test_registry_ganet_matches_the_jax_registry():
    model = tregistry.make_model("ganet", maxdisp=MAXDISP)
    jmodel = jregistry.make_model("ganet", maxdisp=MAXDISP)
    assert isinstance(model, GANetStereo)
    assert (model.num_sga, model.lga is not None, model.use_gwc_volume) == \
        (jmodel.num_sga, jmodel.use_lga, jmodel.use_gwc_volume)


def test_cli_infer_ganet(tmp_path, rng):
    """`cli infer --model ganet` with flax weights (.npz): the PNG of the
    model called directly with the same weights."""
    from test_torch_cli import _direct, _kitti_png, _stereo_png_pair

    from dcanet_tpu_torch.data import io as tio
    from dcanet_tpu_torch.data import submission as tsub

    model, flat = port_and_flat("ganet", MAXDISP, seed=8)
    npz = tmp_path / "weights.npz"
    np.savez(npz, **flat)
    lp, rp = _stereo_png_pair(tmp_path, rng, 30, 60)
    out = tmp_path / "disp.png"
    cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--weights", str(npz),
              "--model", "ganet", "--maxdisp", str(MAXDISP), "--device", "cpu"])
    left, pads = tsub.pad_to_multiple(tio.normalize_imagenet(tio.read_image(lp)), 16)
    right, _ = tsub.pad_to_multiple(tio.normalize_imagenet(tio.read_image(rp)), 16)
    want = _kitti_png(tsub.unpad(_direct(model.eval(), left, right), pads))
    got = tio.read_png(out)
    assert got.shape == (30, 60)
    np.testing.assert_array_equal(got, want)
