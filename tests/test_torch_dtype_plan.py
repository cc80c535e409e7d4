"""The dtype plan of the port's eval forward (dcanet_tpu_torch/ops/
precision.py) on the CPU, read op by op with `chip_smoke.dtype_record` (a
TorchDispatchMode below autocast, the module of each op, the autocast state
of each torch call above it), at maxdisp 32 on one 32x64 pair. chip_smoke.py
phases 3 and 8 take the same record on the card and hold it equal to the
CPU's.

- Rule (c), the bf16 eval of each registry family: no op that bf16 autocast
  would decide on either device (an AutocastCPU or AutocastCUDA kernel in
  the dispatcher's table, for the op or the composite it comes from) runs
  with autocast on, except the convolutions, matmuls and cat / stack
  (`chip_smoke.AUTOCAST_DECIDES`); every convolution takes and returns
  bf16.
- The sites, each in its dtype: the attention's softmax, the SLC pooling,
  the CVA's AvgPool3d (a float32 mean returned in bf16) and its trilinear
  2x in bf16 (rule (b)); the heads' softmax and soft-argmin, GwcNet's
  trilinear 4x and `prop`'s convex blend in float32 (rule (a) and the kept
  heads, ROADMAP Queue 3 item 3); the gwc volume bf16 in and out.
- float32 and float64 evals: every op in the model's dtype (GANet at
  float64 aside: its SGA and LGA weights are float32, `nn/ganet.py`).
- The bf16 train step's plan (`dtype_record(..., disparity=gt)`: one
  train-mode forward with grad on and its loss), which chip_smoke.py phase
  6 holds equal on the card and the CPU: rule (c) for every family; in
  DCANet the same sites as the eval's, in their dtypes, but for the SLC
  statistics in float32, and the ladders' upsamples, softmax and
  soft-argmin, BatchNorm's statistics and the loss in float32; at float32
  and float64 every op of the forward and the loss in the model's dtype.
"""

import pytest
import torch

from chip_smoke import AUTOCAST_DECIDES, dtype_record
from dcanet_tpu_torch.models import registry
from dcanet_tpu_torch.nn.layers import reference_init_

torch.set_num_threads(2)

MAXDISP, H, W = 32, 32, 64
FAMILIES = ("dcanet-cva1", "dcanet-g", "gwcnet-gc", "gwcnet-g", "ganet")
# op names below autocast -> the composite op whose autocast kernel decides them
COMPOSITE = {"aten._softmax.default": "aten::softmax.int", "aten._log_softmax.default": "aten::log_softmax.int"}
BF16, F32 = "bfloat16", "float32"
# model -> (module, op, input dtypes or None, output dtype) that the record
# must hold, every entry of (module, op) in those dtypes
SITES = {
    "dcanet-cva1": (
        ("cva1.slc_net.cross_attention", "aten._softmax.default", (BF16,), BF16),
        ("cva1.slc_net", "aten._softmax.default", (BF16,), BF16),
        ("cva1.slc_net", "aten.exp.default", (BF16,), BF16),
        ("cva1.slc_net", "aten.div.Tensor", (BF16, BF16), BF16),
        ("cva1.slc_net", "aten.sum.dim_IntList", (BF16,), BF16),
        ("cva1.downsample.0", "aten.avg_pool3d.default", (F32,), F32),
        ("cva1.downsample.0", "aten._to_copy.default", None, None),  # f32 -> bf16, then bf16 -> f32
        ("cva1", "aten.upsample_trilinear3d.default", (BF16,), BF16),
        ("", "gwc_volume", (BF16, BF16), BF16),
        ("", "aten._softmax.default", (F32,), F32),
        ("", "aten.sum.dim_IntList", (F32,), F32),
        ("prop", "aten._softmax.default", (F32,), F32),
        ("prop", "aten.sum.dim_IntList", (F32,), F32),
    ),
    "gwcnet-gc": (
        ("", "gwc_volume", (BF16, BF16), BF16),
        ("", "aten.upsample_trilinear3d.default", (F32,), F32),
        ("", "aten._softmax.default", (F32,), F32),
        ("", "aten.sum.dim_IntList", (F32,), F32),
    ),
    "ganet": (
        ("", "gwc_volume", (BF16, BF16), BF16),
        ("sga0", "aten._softmax.default", (F32,), F32),
        ("", "aten._softmax.default", (F32,), F32),
        ("", "aten.sum.dim_IntList", (F32,), F32),
        ("prop", "aten._softmax.default", (F32,), F32),
    ),
}


def autocast_kernel(op: str) -> bool:
    """Whether bf16 autocast on the CPU or CUDA has a kernel of its own
    (not a fallthrough) for the op or its composite."""
    if op == "gwc_volume":
        return False
    op = "aten.native_batch_norm.default" if op == "batch_norm" else op
    name = COMPOSITE.get(op) or "aten::" + op.removeprefix("aten.").removesuffix(".default")
    table = torch._C._dispatch_dump_table(name)
    return any(line.startswith(("AutocastCPU: registered", "AutocastCUDA: registered")) for line in table.splitlines())


# (module, op, input dtypes or None, output dtype) of DCANet's bf16 train step
TRAIN_SITES = (
    ("cva1.slc_net.cross_attention", "aten._softmax.default", (BF16,), BF16),
    ("cva1.slc_net", "aten._softmax.default", (F32,), F32),
    ("cva1.slc_net", "aten.exp.default", (F32,), F32),
    ("cva1.slc_net", "aten.div.Tensor", (F32, F32), F32),
    ("cva1.downsample.0", "aten.avg_pool3d.default", (F32,), F32),
    ("cva1", "aten.upsample_trilinear3d.default", (BF16,), BF16),
    ("", "gwc_volume", (BF16, BF16), BF16),
    ("", "aten.upsample_trilinear3d.default", (F32,), F32),
    ("", "aten._softmax.default", (F32,), F32),
    ("", "aten._log_softmax.default", (F32,), F32),
    ("prop", "aten._softmax.default", (F32,), F32),
    # train-mode BatchNorm, one entry (`dtype_record`): x, weight, bias and
    # the running statistics in, the model's dtype out
    ("dres0.0.1", "batch_norm", (BF16, F32, F32, F32, F32), BF16),
)


def record(name, dtype=torch.bfloat16, train=False):
    model = reference_init_(registry.make_model(name, maxdisp=MAXDISP), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    left, right = (torch.randn(1, 3, H, W, generator=gen) for _ in range(2))
    gt = torch.rand(1, H, W, generator=gen) * (MAXDISP - 4) + 1 if train else None
    if dtype == torch.bfloat16:
        return dtype_record(model, left, right, disparity=gt)
    return dtype_record(model.to(dtype), left.to(dtype), right.to(dtype), autocast=False,
                        disparity=None if gt is None else gt.to(dtype))


def test_autocast_kernels_are_read():
    """The table read sees the kernels that make the devices differ."""
    assert autocast_kernel("aten._softmax.default") and autocast_kernel("aten.avg_pool3d.default")
    assert autocast_kernel("aten.sum.dim_IntList") and autocast_kernel("aten.upsample_trilinear3d.default")
    assert not autocast_kernel("aten.add.Tensor") and not autocast_kernel("batch_norm")


def only_convolutions_and_matmuls_decided(rec):
    decided = [(op, mod, ins, out) for op, mod, ins, out, on in rec
               if on and op not in AUTOCAST_DECIDES and autocast_kernel(op)]
    assert not decided, decided[:5]
    convs = [(mod, ins, out) for op, mod, ins, out, on in rec if op == "aten.convolution.default"]
    assert convs and all(set(ins) == {BF16} and out == BF16 for _, ins, out in convs), convs[:3]


@pytest.mark.parametrize("name", FAMILIES)
def test_autocast_decides_only_convolutions_and_matmuls(name):
    only_convolutions_and_matmuls_decided(record(name))


@pytest.mark.parametrize("name", sorted(SITES))
def test_sites_run_in_their_dtype(name):
    rec = record(name)
    for module, op, ins, out in SITES[name]:
        hits = [(i, o) for p, m, i, o, _ in rec if (m, p) == (module, op)]
        assert hits, (module, op)
        if out is not None:
            assert all(i == ins and o == out for i, o in hits), (module, op, hits)
    pool = [(i, o) for p, m, i, o, _ in rec if m == "cva1.downsample.0"] if name == "dcanet-cva1" else []
    assert not pool or pool[-1] == ((F32,), BF16), pool  # the pool returns the model's dtype


@pytest.mark.parametrize("name, dtype", [("dcanet-cva1", torch.float32), ("dcanet-cva1", torch.float64),
                                         ("gwcnet-gc", torch.float32), ("gwcnet-gc", torch.float64),
                                         ("ganet", torch.float32)])
def test_eval_at_f32_and_f64_runs_in_the_model_dtype(name, dtype):
    want = str(dtype).removeprefix("torch.")
    rec = record(name, dtype)
    assert rec and all(out == want and set(ins) <= {want} for _, _, ins, out, _ in rec), \
        sorted({(op, ins, out) for op, _, ins, out, _ in rec if out != want or set(ins) - {want}})[:5]


@pytest.mark.parametrize("name", FAMILIES)
def test_train_autocast_decides_only_convolutions_and_matmuls(name):
    only_convolutions_and_matmuls_decided(record(name, train=True))


def test_train_sites_run_in_their_dtype():
    rec = record("dcanet-cva1", train=True)
    for module, op, ins, out in TRAIN_SITES:
        hits = [(i, o) for p, m, i, o, _ in rec if (m, p) == (module, op)]
        assert hits, (module, op)
        assert all(i == ins and o == out for i, o in hits), (module, op, hits)
    pool = [(i, o) for p, m, i, o, _ in rec if m == "cva1.downsample.0"]
    assert pool[-1] == ((F32,), BF16), pool  # the pool returns the model's dtype
    # the pooled features stay in the model's dtype; the statistics widen
    slc = [(p, i, o) for p, m, i, o, _ in rec if m == "cva1.slc_net"]
    assert slc[-2:] == [("aten.mul.Tensor", (BF16, BF16), BF16), ("aten.add.Tensor", (BF16, BF16), BF16)], slc[-3:]


@pytest.mark.parametrize("name, dtype", [("dcanet-cva1", torch.float32), ("dcanet-cva1", torch.float64),
                                         ("gwcnet-gc", torch.float32), ("gwcnet-gc", torch.float64)])
def test_train_at_f32_and_f64_runs_in_the_model_dtype(name, dtype):
    want = str(dtype).removeprefix("torch.")
    rec = record(name, dtype, train=True)
    assert rec and all(out == want and set(ins) <= {want} for _, _, ins, out, _ in rec), \
        sorted({(op, ins, out) for op, _, ins, out, _ in rec if out != want or set(ins) - {want}})[:5]
