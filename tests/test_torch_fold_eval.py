"""Eval-mode BatchNorm folded into its conv at bf16 (dcanet_tpu_torch/nn/
layers.py::conv_bn) against the JAX package's fold (dcanet_tpu/nn/layers.py:
48-59, 149-156, 259-262), on the CPU.

- Blocks: each kind of fold site (ConvBNAct 3D, ConvBN 1x1x1, a stride-2
  BasicBlock with its downsample, BasicConv 2D, Projection of one and two
  convs, MultiAggregation with its deconv, Hourglass3D) as a flax module at
  dtype=bfloat16 with the fold on, and as the port's module under CPU bf16
  autocast, on the same variables (BatchNorm statistics and affine drawn as
  tests/test_fold_eval.py draws them) and the same bf16-representable
  input: max |diff| / max(max |want|, 1e-3) <= 2e-2 (the JAX package's own
  folded-vs-literal bound is 5e-2).
- The gate: BatchNorm module forwards counted with hooks. None runs in a
  folded bf16 eval (autocast or a bf16 input); each runs once at f32, at
  float64, in train mode under bf16 autocast and with
  DCANET_FOLD_EVAL_BN=0. In DCANet only Guidance's literal BNs run (its
  ResidualBlocks and `norm1`, as in the JAX package). At f32 and float64
  the output is bit-equal to the literal conv -> BN path.
- The cache of folded weights: reused while the weights stand, and after
  `load_state_dict`, an in-place change of a running variance, an optimizer
  step or `.to()` the folded forward equals a fresh module's; a fold cached
  in inference mode serves a later forward with autograd.
- Models: the port's bf16-autocast eval forward against the JAX bf16 eval
  forward (fold on) of `dcanet-cva1`, `ganet` and `gwcnet-gc` at maxdisp 32
  on one 32x64 pair, the BatchNorm affine drawn as above and the running
  statistics those of one train-mode forward of the pair
  (`chip_smoke.calibrate_batch_norm`, as tests/test_torch_disp_sharding.py
  does): with the drawn statistics the random 2D features reach 1e7-1e8
  and the disparity turns on bf16 rounding alone. Bounds: mean |diff| of
  the disparity below the port's own with DCANET_FOLD_EVAL_BN=0 (the fold
  brings the port to the JAX function) and below 0.25 px, the bound of the
  JAX package's folded-vs-literal DCANet (tests/test_fold_eval.py); for
  `gwcnet-gc`, whose random bf16 forward lies further than that from its
  own f32 forward, below that bf16-vs-f32 distance instead. Each test
  prints the three distances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from torch import nn

from chip_smoke import calibrate_batch_norm
from dcanet_tpu.models import registry as jregistry
from dcanet_tpu.nn import aggregation as jagg
from dcanet_tpu.nn import attention as jatt
from dcanet_tpu.nn import layers as jlayers
from dcanet_tpu_torch import weights as W
from dcanet_tpu_torch.models import registry as tregistry
from dcanet_tpu_torch.nn import layers as L
from dcanet_tpu_torch.nn.aggregation import Hourglass3D, MultiAggregation
from dcanet_tpu_torch.nn.attention import Projection
from dcanet_tpu_torch.nn.layers import BasicBlock, BasicConv, ConvBN, ConvBNAct, reference_init_

torch.set_num_threads(2)

BLOCK_TOL = 2e-2
MODEL_TOL = 0.25
H, Wd, MAXDISP = 32, 64, 32
BF16 = jnp.bfloat16

# name -> (flax module, port module, key table, input shape, channel-last)
BLOCKS = {
    "convbnact_3d": (lambda: jlayers.ConvBNAct(8, 3, 1, 1, dims=3, dtype=BF16),
                     lambda: ConvBNAct(8, 8, 3, 1, 1, dims=3), W.convbn_table("0", "ConvBN_0", 3), (1, 6, 8, 16, 8)),
    "convbn_1x1x1": (lambda: jlayers.ConvBN(8, 1, 1, 0, dims=3, dtype=BF16),
                     lambda: ConvBN(16, 8, 1, 1, 0, dims=3), W.convbn_table("", "", 3), (1, 6, 8, 16, 16)),
    "basic_block_s2": (lambda: jlayers.BasicBlock(16, strides=2, dtype=BF16),
                       lambda: BasicBlock(8, 16, 2), W.basic_block_table("", "", True), (1, 16, 24, 8)),
    "basic_conv_2d": (lambda: jlayers.BasicConv(16, 3, 1, 1, dims=2, dtype=BF16), lambda: BasicConv(8, 16, 3, 1, 1),
                      [("conv.weight", "Conv_0/kernel", "conv2d"), ("bn", "BatchNorm_0/BatchNorm_0", "bn")],
                      (1, 12, 16, 8)),
    "projection_1": (lambda: jatt.Projection(16, 1, True, BF16), lambda: Projection(8, 16, 1),
                     W.projection_table("", "", 1), (1, 6, 4, 8, 8)),
    "projection_2": (lambda: jatt.Projection(16, 2, True, BF16), lambda: Projection(8, 16, 2),
                     W.projection_table("", "", 2), (1, 6, 4, 8, 8)),
    "multi_aggregation": (lambda: jagg.MultiAggregation(8, dtype=BF16), lambda: MultiAggregation(8),
                          W.multi_aggregation_table("", ""), (1, 8, 8, 16, 8)),
    "hourglass3d": (lambda: jagg.Hourglass3D(4, dtype=BF16), lambda: Hourglass3D(4),
                    W.hourglass_table("", ""), (1, 8, 8, 16, 4)),
}


def bf16_values(shape, seed):
    """A float32 array of bf16-representable values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def scaled_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)


@pytest.fixture
def fold_on(monkeypatch):
    monkeypatch.delenv("DCANET_FOLD_EVAL_BN", raising=False)
    return monkeypatch


def draw_batch_norm_(module, seed):
    """Every BatchNorm's affine and running statistics drawn in place as
    tests/test_fold_eval.py draws them: scale ~ N(1, 0.3), bias and mean ~
    N(0, 0.5), var ~ U(0.3, 2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                for t, v in ((m.weight, rng.normal(1.0, 0.3, c)), (m.bias, rng.normal(0.0, 0.5, c)),
                             (m.running_mean, rng.normal(0.0, 0.5, c)), (m.running_var, rng.uniform(0.3, 2.0, c))):
                    t.copy_(torch.from_numpy(v))
    return module.eval()


def port_block(name, seed=0):
    """The port's block with reference-init convs and drawn BatchNorm, and a
    bf16-representable input (channels first)."""
    _, tmod, _, shape = BLOCKS[name]
    block = draw_batch_norm_(reference_init_(tmod(), torch.Generator().manual_seed(seed)), seed)
    return block, channels_first(bf16_values(shape, seed))


def random_model(name, seed):
    """The registry's port model at MAXDISP, reference-init convs and drawn
    BatchNorm."""
    model = reference_init_(tregistry.make_model(name, maxdisp=MAXDISP), torch.Generator().manual_seed(seed))
    return draw_batch_norm_(model, seed)


def run_port(block, x, autocast=True):
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16, enabled=autocast):
        return block(x)


# ---- the blocks against the JAX package's folded blocks ----

@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_folded_block_matches_jax(fold_on, name):
    block, x = port_block(name)
    flat = W.flax_from_state_dict(block.state_dict(), BLOCKS[name][2])
    apply = jax.jit(lambda v, a: BLOCKS[name][0]().apply(v, a, train=False))
    want = np.asarray(apply(unflatten_dict(flat, sep="/"), jnp.asarray(np.moveaxis(x.numpy(), 1, -1), BF16)),
                      np.float32)
    got = run_port(block, x)
    assert got.dtype == torch.bfloat16
    got = np.moveaxis(got.float().numpy(), 1, -1)
    assert got.shape == want.shape
    err = scaled_err(got, want)
    print(f"[fold] {name}: scaled max |port - JAX| {err:.3e} (bound {BLOCK_TOL})")
    assert err <= BLOCK_TOL, err


# ---- the gate ----

def count_bn_forwards(module):
    """A dict filled with the forward calls of each BatchNorm of `module`, by
    name, and the hooks' handles."""
    calls = {}
    handles = [m.register_forward_hook(lambda m, i, o, n=n: calls.__setitem__(n, calls.get(n, 0) + 1))
               for n, m in module.named_modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    return calls, handles


MODES = ("bf16_autocast_eval", "bf16_input_eval", "f32_eval", "f64_eval", "bf16_autocast_train", "switch_off")


def run_mode(module, x, mode, monkeypatch):
    """`module` on x in `mode`; returns the BatchNorm forwards by name."""
    if mode == "switch_off":
        monkeypatch.setenv("DCANET_FOLD_EVAL_BN", "0")
    dtype = {"bf16_input_eval": torch.bfloat16, "f64_eval": torch.float64}.get(mode, torch.float32)
    module = module.to(dtype).train(mode == "bf16_autocast_train")
    calls, handles = count_bn_forwards(module)
    try:
        with torch.no_grad(), torch.autocast("cpu", torch.bfloat16, enabled="autocast" in mode or mode == "switch_off"):
            module(*(t.to(dtype) for t in x))
    finally:
        for h in handles:
            h.remove()
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_gate_runs_batch_norm_only_where_the_fold_is_off(fold_on, mode):
    folded = mode in ("bf16_autocast_eval", "bf16_input_eval")
    for name in BLOCKS:
        block, x = port_block(name)
        names = {n for n, m in block.named_modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)}
        calls = run_mode(block, (x,), mode, fold_on)
        assert calls == ({} if folded else dict.fromkeys(names, 1)), (name, calls)


def literal_path(monkeypatch):
    """The conv -> BatchNorm modules as the unfolded port runs them."""
    monkeypatch.setattr(L.ConvBNSequential, "forward", nn.Sequential.forward)
    monkeypatch.setattr(L, "conv_bn", lambda conv, bn, x, shard=None: bn(conv(x)))


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_is_bit_equal_to_the_literal_path(fold_on, name, dtype):
    block, x = port_block(name)
    block, x = block.to(dtype), x.to(dtype)
    got = run_port(block, x, autocast=False)
    with pytest.MonkeyPatch.context() as mp:
        literal_path(mp)
        want = run_port(block, x, autocast=False)
    assert got.dtype == dtype and torch.equal(got, want)


def images(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, H, Wd, 3)).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def dcanet():
    model = random_model("dcanet-cva1", 0)
    return model, tuple(channels_first(x) for x in images(0))


def test_dcanet_folded_eval_runs_only_guidance_batch_norm(fold_on, dcanet):
    """Guidance's `norm1` and ResidualBlocks keep their BN (their JAX
    counterparts have no fold); every other BN is folded."""
    model, pair = dcanet
    literal = {n for n, m in model.named_modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
               and (n == "guidance.norm1" or n.startswith("guidance.layer"))}
    assert len(literal) == 10
    assert run_mode(copy.deepcopy(model), pair, "bf16_autocast_eval", fold_on) == dict.fromkeys(literal, 1)
    everything = run_mode(copy.deepcopy(model), pair, "switch_off", fold_on)
    assert len(everything) > 40 and set(everything.values()) == {1} and literal < set(everything)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dcanet_eval_is_bit_equal_to_the_literal_path(fold_on, dcanet, dtype):
    model, pair = dcanet
    model = copy.deepcopy(model).to(dtype)
    pair = tuple(t.to(dtype) for t in pair)
    with torch.no_grad():
        got = model(*pair)
        with pytest.MonkeyPatch.context() as mp:
            literal_path(mp)
            want = model(*pair)
    assert got.disparity.dtype == dtype and torch.equal(got.disparity, want.disparity)
    assert all(torch.equal(a, b) for a, b in zip(got.class_logits, want.class_logits))


# ---- the cache of folded weights ----

def aggregation(seed):
    return port_block("multi_aggregation", seed)


def fresh_copy(block):
    other = MultiAggregation(8)
    other.load_state_dict(block.state_dict(), strict=True)
    return other.eval()


def test_cache_is_reused_while_the_weights_stand(fold_on):
    block, x = aggregation(0)
    run_port(block, x)
    with torch.no_grad():
        first = L._folded(*block.conv3)
    run_port(block, x)
    with torch.no_grad():
        again = L._folded(*block.conv3)
    assert first[0] is again[0] and first[1] is again[1]
    assert first[0].dtype == torch.bfloat16 and not first[0].requires_grad


def change_weights(block, change):
    if change == "load_state_dict":
        other, _ = aggregation(1)
        block.load_state_dict(other.state_dict(), strict=True)
    elif change == "running_var":
        block.conv1[0][1].running_var.mul_(2.0)
        block.conv3[1].running_var.add_(0.5)
    elif change == "optimizer_step":
        x = torch.randn(1, 8, 8, 16, 16)
        opt = torch.optim.SGD(block.parameters(), lr=0.05)
        with torch.autocast("cpu", torch.bfloat16):
            loss = block(x).float().square().mean()
        loss.backward()
        # the folded eval forward with autograd reaches the conv and BN parameters
        assert block.conv3[0].weight.grad is not None and block.conv3[1].weight.grad is not None
        assert block.conv1[0][1].bias.grad is not None
        opt.step()
    elif change == "to":
        block.to(torch.bfloat16).to(torch.float32)  # new tensors, the weights rounded


@pytest.mark.parametrize("change", ["load_state_dict", "running_var", "optimizer_step", "to"])
def test_cache_follows_the_weights(fold_on, change):
    block, x = aggregation(0)
    before = run_port(block, x)
    change_weights(block, change)
    got = run_port(block, x)
    want = run_port(fresh_copy(block), x)
    assert torch.equal(got, want)
    assert not torch.equal(got, before)


def test_fold_cached_in_inference_mode_serves_autograd(fold_on):
    block, x = aggregation(0)
    block.requires_grad_(False)
    with torch.inference_mode(), torch.autocast("cpu", torch.bfloat16):
        want = block(x)
    x = x.clone().requires_grad_()
    with torch.autocast("cpu", torch.bfloat16):
        got = block(x)
    got.float().sum().backward()
    assert torch.equal(got.detach(), want) and x.grad is not None


# ---- the models against the JAX package ----

def jax_disparity(name, maxdisp, flat, left, right):
    """The JAX registry model's bf16 eval disparity, under the fold switch
    as it is now (traced afresh)."""
    model = jregistry.make_model(name, maxdisp=maxdisp, dtype=BF16)
    fn = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False).disparity)
    return np.asarray(fn(unflatten_dict(flat, sep="/"), jnp.asarray(left), jnp.asarray(right)), np.float32)


def port_disparity(model, left, right):
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        out = model(channels_first(left), channels_first(right)).disparity
    assert out.dtype == torch.float32 and out.shape == (1, H, Wd)
    return out.numpy()


@pytest.mark.parametrize("name", ["dcanet-cva1", "ganet", "gwcnet-gc"])
def test_bf16_eval_matches_jax(fold_on, name):
    model = random_model(name, seed=0)
    left, right = images(0)
    calibrate_batch_norm(model, channels_first(left), channels_first(right))
    want = jax_disparity(name, MAXDISP, W.to_jax_variables(model.state_dict(), model), left, right)
    got = port_disparity(model, left, right)
    with torch.no_grad():
        f32 = model(channels_first(left), channels_first(right)).disparity.numpy()
    fold_on.setenv("DCANET_FOLD_EVAL_BN", "0")
    folded, literal, own_f32 = (float(np.abs(a - b).mean())
                                for a, b in ((got, want), (port_disparity(model, left, right), want), (got, f32)))
    bound = own_f32 if name == "gwcnet-gc" else MODEL_TOL
    print(f"[fold] {name} maxdisp {MAXDISP} bf16 eval, mean |port - JAX|: {folded:.4f} px folded (bound "
          f"{bound:.4f}), {literal:.4f} px with the port's BN literal; the port's folded bf16 - its f32 "
          f"{own_f32:.4f} px")
    assert folded < literal and folded < bound
