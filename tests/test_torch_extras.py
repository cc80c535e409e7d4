"""The extras of the port (nn/extras.py, nn/context.py, resize_bilinear,
softargmin_disparity, utils/summary.py, utils/profiling.py) against the JAX
package, on the CPU.

Each module is held against its flax twin: the flax module's variables
(shapes from `jax.eval_shape` of its init) are drawn with numpy, BatchNorm
affine parameters, running statistics, biases and Dense kernels random too,
and the same variables are carried into the port's module by its key table
in `weights.py` (strict load). Both run
the same numpy input in float32, in eval mode and in train mode; outputs
and the updated BatchNorm statistics (flax's mutated `batch_stats`) are
compared after scaling by max(|reference|, 1), at 1e-4 (float32 sums in
another order through up to ~20 layers). The ops are compared at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from dcanet_tpu.models import registry as jregistry
from dcanet_tpu.nn import context as jcontext
from dcanet_tpu.nn import extras as jextras
from dcanet_tpu.ops import regression as jregression
from dcanet_tpu.ops import upsample as jupsample
from dcanet_tpu.utils import profiling as jprofiling
from dcanet_tpu.utils import summary as jsummary
from dcanet_tpu_torch import ops
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.models import registry as tregistry
from dcanet_tpu_torch.nn import context as tcontext
from dcanet_tpu_torch.nn import extras as textras
from dcanet_tpu_torch.utils import profiling as tprofiling
from dcanet_tpu_torch.utils import summary as tsummary

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)


def draw_variables(shapes, seed):
    """Flat numpy flax variables of the given shapes (`jax.eval_shape` of
    the module's init): conv kernels as the reference init draws them, random
    BN affine and statistics, biases and Dense kernels (a fresh BN is an
    identity and a zero bias a no-op, which would hide layout faults)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in flatten_dict(shapes, sep="/").items():
        if k.endswith("/mean"):
            arr = rng.normal(0.0, 0.2, v.shape)
        elif k.endswith("/var") or k.endswith("/scale"):
            arr = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/bias"):
            arr = rng.normal(0.0, 0.1, v.shape)
        elif "Dense_" in k:
            arr = rng.normal(0.0, 1.0 / np.sqrt(v.shape[0]), v.shape)
        else:
            arr = rng.normal(0.0, np.sqrt(2.0 / (np.prod(v.shape[:-2]) * v.shape[-1])), v.shape)
        flat[k] = arr.astype(np.float32)
    return flat


def channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def channels_last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def assert_scaled_close(got, want, atol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def run_both(fmod, fargs, tmod, targs, train, takes_train=True, seed=1):
    """flax apply and port forward on the same variables, in train or eval
    mode; returns (flax out, port out, flax batch_stats after, port's)."""
    tail = (train,) if takes_train else ()
    flat = draw_variables(jax.eval_shape(lambda: fmod.init(KEY, *fargs, *tail)), seed)
    table = W.model_table(tmod)
    tmod.load_state_dict(W.state_dict_from_flax(flat, table), strict=True)
    tmod.train(train)
    apply = jax.jit(lambda v, *a: fmod.apply(v, *a, *tail, mutable=["batch_stats"]))
    fout, upd = apply(unflatten_dict(flat, sep="/"), *fargs)
    with torch.no_grad():
        tout = tmod(*targs)
    fstats = {k: np.asarray(v) for k, v in flatten_dict(upd, sep="/").items()}  # "batch_stats/..."
    tstats = {k: v for k, v in W.flax_from_state_dict(tmod.state_dict(), table).items() if k in fstats}
    assert set(tstats) == set(fstats)
    return fout, tout, fstats, tstats


def check(fmod, fargs, tmod, targs, train, takes_train=True, to_flax=channels_last):
    fout, tout, fstats, tstats = run_both(fmod, fargs, tmod, targs, train, takes_train)
    if isinstance(fout, dict):
        for key in fout:
            assert_scaled_close(to_flax(tout[key]), fout[key])
    else:
        assert_scaled_close(to_flax(tout), fout)
    for k in fstats:
        assert_scaled_close(tstats[k], fstats[k])
    if not train:
        assert all(np.array_equal(tstats[k], fstats[k]) for k in fstats)  # eval leaves them alone


def _x(rng, shape):
    return (rng.standard_normal(shape) * 1.5 + 0.2).astype(np.float32)


MODES = pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])

# ---- nn/extras.py ----


@MODES
@pytest.mark.parametrize("with_bn,stride,pad,dil", [(True, 1, 2, 2), (False, 2, 1, 1)])
def test_conv2d_batchnorm_relu(rng, train, with_bn, stride, pad, dil):
    x = _x(rng, (2, 9, 11, 5))
    check(jextras.Conv2DBatchNormRelu(6, 3, stride, pad, dil, with_bn=with_bn), (jnp.asarray(x),),
          textras.Conv2DBatchNormRelu(5, 6, 3, stride, pad, dil, with_bn=with_bn), (channels_first(x),), train)


@MODES
@pytest.mark.parametrize("fusion_mode", ["cat", "sum"])
def test_pyramid_pooling(rng, train, fusion_mode):
    """13x17 at pool sizes (8, 4, 2, 1): floor geometry, then resizes from
    1x2, 3x4, 6x8 back to 13x17 (non-integer scales, edges clamped)."""
    x = _x(rng, (2, 13, 17, 8))
    check(jextras.PyramidPooling((8, 4, 2, 1), fusion_mode), (jnp.asarray(x),),
          textras.PyramidPooling(8, (8, 4, 2, 1), fusion_mode), (channels_first(x),), train)


@MODES
@pytest.mark.parametrize("cin,cout,stride,ratio", [(8, 8, 1, 2), (8, 12, 2, 2), (8, 8, 1, 1)],
                         ids=["residual", "stride2", "expanse1"])
def test_mobile_v2_residual(rng, train, cin, cout, stride, ratio):
    x = _x(rng, (2, 10, 14, cin))
    tmod = textras.MobileV2Residual(cin, cout, stride, ratio)
    assert tmod.use_res == (stride == 1 and cin == cout)
    check(jextras.MobileV2Residual(cout, stride, ratio), (jnp.asarray(x),), tmod, (channels_first(x),), train)


@MODES
def test_hourglass2d(rng, train):
    x = _x(rng, (1, 16, 24, 8))
    check(jextras.Hourglass2D(8), (jnp.asarray(x),), textras.Hourglass2D(8), (channels_first(x),), train)


@MODES
def test_unet_feature_extractor(rng, train):
    x = _x(rng, (1, 128, 128, 3))
    tmod = textras.UNetFeatureExtractor()
    check(jextras.UNetFeatureExtractor(), (jnp.asarray(x),), tmod, (channels_first(x),), train)
    with torch.no_grad():
        out = tmod(channels_first(x))
    assert tuple(out["gwc_feature"].shape) == (1, 160, 32, 32)
    assert tuple(out["concat_feature"].shape) == (1, 12, 32, 32)


# ---- nn/context.py (volumes NDHWC in flax, NCDHW in the port) ----


@MODES
def test_nonlocal_attention(rng, train):
    q, k = _x(rng, (1, 4, 4, 6, 16)), _x(rng, (1, 4, 4, 6, 16))
    check(jcontext.NonLocalAttention(16, 12), (jnp.asarray(q), jnp.asarray(k)),
          tcontext.NonLocalAttention(16, 16, 12), (channels_first(q), channels_first(k)), train)


@MODES
@pytest.mark.parametrize("concat_input", [True, False])
def test_image_level_context(rng, train, concat_input):
    x = _x(rng, (1, 6, 4, 5, 16))
    check(jcontext.ImageLevelContext(8, 16, concat_input), (jnp.asarray(x),),
          tcontext.ImageLevelContext(16, 8, 16, concat_input), (channels_first(x),), train)


@MODES
def test_disparity_level_context(rng, train):
    """D = 6 != C = 8: a c-major flatten of the (D, C) features would
    permute the gate."""
    x = _x(rng, (2, 6, 4, 5, 8))
    check(jcontext.DisparityLevelContext(8, reduction=4), (jnp.asarray(x),),
          tcontext.DisparityLevelContext(8, 6, reduction=4), (channels_first(x),), train)


def test_disparity_level_context_is_d_major(rng):
    """The gate of feature (d, c) is the flax Dense's output d*C + c: with a
    zero fc1 the gate is sigmoid(fc2.bias), so the bias's order shows."""
    m = tcontext.DisparityLevelContext(8, 6, reduction=4)
    bias = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    with torch.no_grad():
        m.fc1.weight.zero_()
        m.fc1.bias.zero_()
        m.fc2.bias.copy_(bias)
        y = m(torch.ones(1, 8, 6, 2, 3))
    np.testing.assert_allclose(y[0, :, :, 0, 0].numpy(), torch.sigmoid(bias).view(6, 8).T.numpy(), rtol=1e-6)


@MODES
def test_se_layer_d(rng, train):
    x = _x(rng, (2, 16, 4, 5, 3))
    check(jcontext.SELayerD(16), (jnp.asarray(x),), tcontext.SELayerD(16), (channels_first(x),), train,
          takes_train=False)


@MODES
def test_semantic_level_context_local(rng, train):
    x, logits = _x(rng, (1, 6, 4, 5, 16)), _x(rng, (1, 6, 4, 5))
    check(jcontext.SemanticLevelContextLocal(8, 16), (jnp.asarray(x), jnp.asarray(logits)),
          tcontext.SemanticLevelContextLocal(16, 8, 16), (channels_first(x), torch.from_numpy(logits)), train)


# ---- tables ----

TABLE_CASES = {
    "conv2d_bn_relu": (lambda: jextras.Conv2DBatchNormRelu(6), (1, 8, 8, 5),
                       lambda: textras.Conv2DBatchNormRelu(5, 6)),
    "conv2d_relu_no_bn": (lambda: jextras.Conv2DBatchNormRelu(6, with_bn=False), (1, 8, 8, 5),
                          lambda: textras.Conv2DBatchNormRelu(5, 6, with_bn=False)),
    "pyramid_pooling_no_bn": (lambda: jextras.PyramidPooling((4, 2), "sum", with_bn=False), (1, 8, 8, 4),
                              lambda: textras.PyramidPooling(4, (4, 2), "sum", with_bn=False)),
    "mobile_v2": (lambda: jextras.MobileV2Residual(8), (1, 8, 8, 8), lambda: textras.MobileV2Residual(8, 8)),
    "mobile_v2_expanse1": (lambda: jextras.MobileV2Residual(8, expanse_ratio=1), (1, 8, 8, 8),
                           lambda: textras.MobileV2Residual(8, 8, expanse_ratio=1)),
    "hourglass2d": (lambda: jextras.Hourglass2D(4), (1, 8, 8, 4), lambda: textras.Hourglass2D(4)),
    "unet": (lambda: jextras.UNetFeatureExtractor(), (1, 128, 128, 3), lambda: textras.UNetFeatureExtractor()),
    "image_level_context": (lambda: jcontext.ImageLevelContext(8, 16), (1, 2, 2, 2, 16),
                            lambda: tcontext.ImageLevelContext(16, 8, 16)),
    "disparity_level_context": (lambda: jcontext.DisparityLevelContext(8), (1, 4, 2, 2, 8),
                                lambda: tcontext.DisparityLevelContext(8, 4)),
    "semantic_level_context_local": (lambda: jcontext.SemanticLevelContextLocal(8, 16), (1, 4, 2, 2, 16),
                                     lambda: tcontext.SemanticLevelContextLocal(16, 8, 16)),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_uses_every_flax_variable(case):
    """Key for key: the table's flax paths are the module's variables, its
    torch keys the port module's state_dict (less num_batches_tracked), and
    every tensor keeps its element count."""
    jmod_fn, shape, tmod_fn = TABLE_CASES[case]
    jmod, tmod = jmod_fn(), tmod_fn()
    args = [jnp.zeros(shape)]
    if case == "semantic_level_context_local":
        args.append(jnp.zeros(shape[:4]))
    shapes = flatten_dict(jax.eval_shape(lambda: jmod.init(KEY, *args, False)), sep="/")
    pairs = list(W._pairs(W.model_table(tmod)))
    assert sorted(f for _, f, _ in pairs) == sorted(shapes)
    sd = {k: v for k, v in tmod.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(t for t, _, _ in pairs) == sorted(sd)
    for t, f, _ in pairs:
        assert sd[t].numel() == np.prod(shapes[f].shape), (t, f)


def test_depthwise_kernel_layout(rng):
    """A flax depthwise kernel (3, 3, 1, hidden) goes through the conv2d
    rule to torch's (hidden, 1, 3, 3), tap for tap."""
    w = rng.standard_normal((3, 3, 1, 16)).astype(np.float32)
    sd = W.state_dict_from_flax({"params/k": w}, [("dw", "k", "conv2d")])
    assert tuple(sd["dw"].shape) == (16, 1, 3, 3)
    np.testing.assert_array_equal(sd["dw"][5, 0].numpy(), w[:, :, 0, 5])


def test_dense_and_deconv2d_layouts_round_trip(rng):
    for kind, shape in (("dense", (6, 4)), ("deconv2d", (3, 3, 5, 7))):
        w = rng.standard_normal(shape).astype(np.float32)
        table = [("m.weight", "m/kernel", kind)]
        sd = W.state_dict_from_flax({"params/m/kernel": w}, table)
        np.testing.assert_array_equal(W.flax_from_state_dict(sd, table)["params/m/kernel"], w)
    assert tuple(W.state_dict_from_flax({"params/k": np.zeros((6, 4))}, [("w", "k", "dense")])["w"].shape) == (4, 6)


# ---- ops ----


def test_fmish_matches_jax(rng):
    x = np.concatenate([rng.standard_normal(1000) * 4, [-40.0, -20.0, 0.0, 20.0, 40.0]]).astype(np.float32)
    np.testing.assert_allclose(textras.fmish(torch.from_numpy(x)).numpy(), np.asarray(jextras.fmish(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("shape", [(2, 7, 9), (2, 5, 11, 3)], ids=["rank3", "rank4"])
def test_resize_bilinear_matches_jax(rng, scale, shape):
    """Odd H and W; every edge row and column included."""
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jupsample.resize_bilinear(jnp.asarray(x), scale))
    t = torch.from_numpy(x) if len(shape) == 3 else channels_first(x)
    got = ops.resize_bilinear(t, scale)
    got = got.numpy() if len(shape) == 3 else channels_last(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_softargmin_disparity_matches_jax(rng):
    cost = (rng.standard_normal((2, 8, 5, 7)) * 3).astype(np.float32)
    want = np.asarray(jregression.softargmin_disparity(jnp.asarray(cost), 8))
    np.testing.assert_allclose(ops.softargmin_disparity(torch.from_numpy(cost), 8).numpy(), want, atol=1e-6, rtol=0)


# ---- utils/summary.py ----


@pytest.mark.parametrize("name", sorted(jregistry.MODELS))
def test_count_params_matches_jax(name):
    """Parameters only (not BN statistics), for every registry name; the
    flax shapes from jax.eval_shape, nothing computed."""
    jmodel = jregistry.make_model(name, maxdisp=48)
    sample = jnp.zeros((1, 64, 192, 3), jnp.float32)
    variables = jax.eval_shape(lambda: jmodel.init(KEY, sample, sample, train=True))
    want = jsummary.count_params(variables["params"])
    model = tregistry.make_model(name, maxdisp=48)
    assert tsummary.count_params(model) == want
    assert tsummary.count_params(model.state_dict()) == want


def test_summarize_on_the_cpu():
    model = tregistry.make_model("dcanet-cva1", maxdisp=32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    text = tsummary.summarize(model, (64, 128), train=True, depth=1, device="cpu")
    lines = text.splitlines()
    assert lines[0].split() == ["module", "type", "output", "shape", "params"]
    assert lines[1].startswith("(model)") and "DCANet" in lines[1]
    assert any(line.startswith("feature_extraction ") and "(2, 320, 16, 32)" in line for line in lines)
    assert not any(line.startswith("feature_extraction.") for line in lines)  # depth 1
    assert lines[-1].startswith(f"total params: {tsummary.count_params(model):,}")
    assert model.training  # the mode it had
    for k, v in model.state_dict().items():  # train mode left the BN statistics alone
        assert torch.equal(v, before[k]), k
    eval_text = tsummary.summarize(model.eval(), (64, 128), train=False, depth=2, device="cpu")
    assert "feature_extraction.firstconv" in eval_text and not model.training


def test_summarize_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsummary.summarize(tregistry.make_model("dcanet-cva0", maxdisp=32))


# ---- utils/profiling.py ----


def test_device_time_on_cpu_tensors():
    calls = []
    x = torch.ones(64, 64)

    def fn(a):
        calls.append(1)
        return a @ a

    t = tprofiling.device_time(fn, x, iters=4)
    assert np.isfinite(t) and t > 0 and len(calls) == 2 + 4
    with pytest.raises(ValueError, match="tensor"):
        tprofiling.device_time(lambda n: n, 3)
    import inspect

    assert list(inspect.signature(tprofiling.device_time).parameters) == \
        list(inspect.signature(jprofiling.device_time).parameters)


def test_step_timer_matches_jax(monkeypatch):
    """On a fake clock: 3 steps of batch 3 in 2 s."""
    import time

    clock = iter([10.0, 10.0, 12.0, 12.0, 12.0, 12.0, 20.0, 20.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timers = tprofiling.StepTimer(3), jprofiling.StepTimer(3)  # reset at 10.0 each
    for timer in timers:
        timer.tick()
        timer.tick(2)
    assert [(t.steps_per_sec, t.pairs_per_sec) for t in timers] == [(1.5, 4.5), (1.5, 4.5)]
    timers[0].reset()  # at 20.0
    assert timers[0].steps_per_sec == 0.0


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    with tprofiling.trace(str(tmp_path)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and '"traceEvents"' in files[0].read_text()
