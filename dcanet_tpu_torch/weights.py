"""Weight bridge: flax variables of dcanet_tpu's models <-> the port's state_dicts.

The port's own copy of the key tables between the reference's state_dict
keys (the port's module names) and the JAX package's flax paths, one per
model family (`model_table`: DCANet by `num_cva` and `use_concat_volume`,
GwcNetBaseline, GANetStereo, whose module names are the port's own) and one
per module of `nn/extras.py` and `nn/context.py` (`model_table` takes those
modules too), with the layout transforms:

  conv2d    torch OIHW          <-> flax HWIO (a depthwise conv's
            (hidden, 1, kh, kw) <-> (kh, kw, 1, hidden) too)
  conv3d    torch OIDHW         <-> flax DHWIO
  deconv3d  torch ConvTranspose3d IODHW <-> flax DHW(I,O), spatially flipped
            (the JAX package runs it as an lhs-dilated correlation)
  deconv2d  the same for ConvTranspose2d IOHW <-> flax HW(I,O)
  dense     torch Linear (out, in) <-> flax Dense (in, out)
  bias      copied as is
  bn        weight/bias <-> params scale/bias,
            running_mean/running_var <-> batch_stats mean/var

Flat flax variables are keyed by '/'-joined paths that start with the
collection, e.g. `params/cva1/fuse/Conv_0/kernel` or
`batch_stats/guidance/BatchNorm_0/BatchNorm_0/mean`
(flax.traverse_util.flatten_dict(variables, sep="/")).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

Entry = Tuple[str, str, str]  # (torch key or prefix, flax path, kind)


def _t(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _f(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def convbn_table(tp: str, fp: str, dims: int) -> List[Entry]:
    """torch Sequential(conv, bn) <-> flax ConvBN scope."""
    kind = "conv3d" if dims == 3 else "conv2d"
    return [
        (_t(tp, "0.weight"), _f(fp, "Conv_0/kernel"), kind),
        (_t(tp, "1"), _f(fp, "BatchNorm_0/BatchNorm_0"), "bn"),
    ]


def basic_block_table(tp: str, fp: str, downsample: bool) -> List[Entry]:
    out = convbn_table(_t(tp, "conv1.0"), _f(fp, "ConvBNAct_0/ConvBN_0"), 2)
    out += convbn_table(_t(tp, "conv2"), _f(fp, "ConvBN_0"), 2)
    if downsample:
        out += [
            (_t(tp, "downsample.0.weight"), _f(fp, "Conv_0/kernel"), "conv2d"),
            (_t(tp, "downsample.1"), _f(fp, "BatchNorm_0/BatchNorm_0"), "bn"),
        ]
    return out


def feature_extraction_table(tp: str, fp: str, concat: bool = True) -> List[Entry]:
    out = []
    for i, seq in enumerate((0, 2, 4)):
        out += convbn_table(_t(tp, f"firstconv.{seq}"), _f(fp, f"ConvBNAct_{i}/ConvBN_0"), 2)
    blk = 0
    for layer, (n, ch_change) in enumerate(zip((3, 16, 3, 3), (False, True, True, False)), start=1):
        for j in range(n):
            out += basic_block_table(
                _t(tp, f"layer{layer}.{j}"), _f(fp, f"BasicBlock_{blk}"), downsample=j == 0 and ch_change
            )
            blk += 1
    if concat:
        out += convbn_table(_t(tp, "lastconv.0"), _f(fp, "ConvBNAct_3/ConvBN_0"), 2)
        out.append((_t(tp, "lastconv.2.weight"), _f(fp, "Conv_0/kernel"), "conv2d"))
    return out


def residual_block_table(tp: str, fp: str, downsample: bool) -> List[Entry]:
    out = []
    for i in (1, 2):
        out += [
            (_t(tp, f"conv{i}.weight"), _f(fp, f"Conv_{i - 1}/kernel"), "conv2d"),
            (_t(tp, f"conv{i}.bias"), _f(fp, f"Conv_{i - 1}/bias"), "bias"),
            (_t(tp, f"norm{i}"), _f(fp, f"BatchNorm_{i - 1}/BatchNorm_0"), "bn"),
        ]
    if downsample:
        out += [
            (_t(tp, "downsample.0.weight"), _f(fp, "Conv_2/kernel"), "conv2d"),
            (_t(tp, "downsample.0.bias"), _f(fp, "Conv_2/bias"), "bias"),
            (_t(tp, "downsample.1"), _f(fp, "BatchNorm_2/BatchNorm_0"), "bn"),
        ]
    return out


def guidance_table(tp: str, fp: str) -> List[Entry]:
    out = [
        (_t(tp, "conv_start.0.weight"), _f(fp, "Conv_0/kernel"), "conv2d"),
        (_t(tp, "conv_start.0.bias"), _f(fp, "Conv_0/bias"), "bias"),
        (_t(tp, "norm1"), _f(fp, "BatchNorm_0/BatchNorm_0"), "bn"),
    ]
    for i, (name, down) in enumerate((("layer1.0", False), ("layer1.1", False), ("layer2.0", True), ("layer2.1", False))):
        out += residual_block_table(_t(tp, name), _f(fp, f"ResidualBlock_{i}"), down)
    for i in range(2):
        out += [
            (_t(tp, f"conv_g0.{i}.conv.weight"), _f(fp, f"BasicConv_{i}/Conv_0/kernel"), "conv2d"),
            (_t(tp, f"conv_g0.{i}.bn"), _f(fp, f"BasicConv_{i}/BatchNorm_0/BatchNorm_0"), "bn"),
        ]
    out.append((_t(tp, "guidance.weight"), _f(fp, "Conv_1/kernel"), "conv2d"))
    return out


def propagation_table(tp: str, fp: str) -> List[Entry]:
    out = convbn_table(_t(tp, "conv.0"), _f(fp, "ConvBNAct_0/ConvBN_0"), 2)
    out.append((_t(tp, "conv.2.weight"), _f(fp, "Conv_0/kernel"), "conv2d"))
    return out


def projection_table(tp: str, fp: str, num_convs: int) -> List[Entry]:
    out = []
    for i in range(num_convs):
        p = _t(tp, str(i)) if num_convs > 1 else tp
        out += [
            (_t(p, "0.weight"), _f(fp, f"Conv_{i}/kernel"), "conv3d"),
            (_t(p, "1"), _f(fp, f"BatchNorm_{i}/BatchNorm_0"), "bn"),
        ]
    return out


def attention_table(tp: str, fp: str) -> List[Entry]:
    out = []
    for name, n in (("query_project", 2), ("key_project", 2), ("value_project", 1), ("out_project", 1)):
        out += projection_table(_t(tp, name), _f(fp, name), n)
    return out


def multi_aggregation_table(tp: str, fp: str) -> List[Entry]:
    out = convbn_table(_t(tp, "conv1.0"), _f(fp, "conv1/ConvBN_0"), 3)
    out += convbn_table(_t(tp, "conv2.0"), _f(fp, "conv2/ConvBN_0"), 3)
    out += [
        (_t(tp, "conv3.0.weight"), _f(fp, "conv3/kernel"), "deconv3d"),
        (_t(tp, "conv3.1"), _f(fp, "conv3_bn/BatchNorm_0"), "bn"),
    ]
    out += convbn_table(_t(tp, "redir"), _f(fp, "redir"), 3)
    return out


def cva_table(tp: str, fp: str) -> List[Entry]:
    out = convbn_table(_t(tp, "downsample.1"), _f(fp, "down_conv/ConvBN_0"), 3)
    out += convbn_table(_t(tp, "classify.0"), _f(fp, "classify0/ConvBN_0"), 3)
    out.append((_t(tp, "classify.2.weight"), _f(fp, "classify1/kernel"), "conv3d"))
    out += attention_table(_t(tp, "slc_net.cross_attention"), _f(fp, "slc/cross_attention"))
    out += convbn_table(_t(tp, "fuse.0"), _f(fp, "fuse"), 3)
    out += multi_aggregation_table(_t(tp, "cost_agg"), _f(fp, "cost_agg"))
    return out


def classifier_table(tp: str, fp: str) -> List[Entry]:
    out = convbn_table(_t(tp, "0"), _f(fp, "ConvBNAct_0/ConvBN_0"), 3)
    out.append((_t(tp, "2.weight"), _f(fp, "Conv_0/kernel"), "conv3d"))
    return out


def hourglass_table(tp: str, fp: str) -> List[Entry]:
    """Plain GwcNet's Hourglass3D; the deconvs' BN is the reference's `conv5.1`."""
    out = []
    for conv in ("conv1", "conv2", "conv3", "conv4"):
        out += convbn_table(_t(tp, f"{conv}.0"), _f(fp, f"{conv}/ConvBN_0"), 3)
    for deconv in ("conv5", "conv6"):
        out += [
            (_t(tp, f"{deconv}.0.weight"), _f(fp, f"{deconv}/kernel"), "deconv3d"),
            (_t(tp, f"{deconv}.1"), _f(fp, f"{deconv}_bn/BatchNorm_0"), "bn"),
        ]
    out += convbn_table(_t(tp, "redir1"), _f(fp, "redir1"), 3)
    out += convbn_table(_t(tp, "redir2"), _f(fp, "redir2"), 3)
    return out


def _pre_aggregation_table() -> List[Entry]:
    """dres0 = Sequential(convbn, ReLU, convbn, ReLU), dres1 = (convbn, ReLU,
    convbn) <-> the models' first auto-named 3D ConvBNs."""
    out = convbn_table("dres0.0", "ConvBNAct_0/ConvBN_0", 3)
    out += convbn_table("dres0.2", "ConvBNAct_1/ConvBN_0", 3)
    out += convbn_table("dres1.0", "ConvBNAct_2/ConvBN_0", 3)
    out += convbn_table("dres1.2", "ConvBN_0", 3)
    return out


def dcanet_table(num_cva: int = 3, use_concat: bool = True) -> List[Entry]:
    """The whole DCANet(num_cva, use_concat_volume=use_concat)."""
    out = feature_extraction_table("feature_extraction", "feature_extraction", concat=use_concat)
    out += guidance_table("guidance", "guidance")
    out += _pre_aggregation_table()
    for i in range(1, num_cva + 1):
        out += cva_table(f"cva{i}", f"cva{i}")
    for i in range(num_cva + 1):
        out += classifier_table(f"classif{i}", f"classif{i}")
    out += propagation_table("prop", "prop")
    return out


def gwcnet_table(use_concat: bool = True) -> List[Entry]:
    """GwcNetBaseline: features, dres0/1, Hourglass3D dres2-4, classif0-3 (no
    guidance, no prop)."""
    out = feature_extraction_table("feature_extraction", "feature_extraction", concat=use_concat)
    out += _pre_aggregation_table()
    for name in ("dres2", "dres3", "dres4"):
        out += hourglass_table(name, name)
    for i in range(4):
        out += classifier_table(f"classif{i}", f"classif{i}")
    return out


def guided_block_table(tp: str, fp: str) -> List[Entry]:
    """SGABlock / LGABlock: guide = Sequential(ConvBN, ReLU, Conv2d)."""
    out = convbn_table(_t(tp, "guide.0"), _f(fp, "ConvBNAct_0/ConvBN_0"), 2)
    out.append((_t(tp, "guide.2.weight"), _f(fp, "Conv_0/kernel"), "conv2d"))
    return out


def ganet_table(num_sga: int = 2, use_lga: bool = True) -> List[Entry]:
    """GANetStereo: features, guidance, dres0/1, sga{i} with its head
    classif_sga{i}, lga, classif_final, prop."""
    out = feature_extraction_table("feature_extraction", "feature_extraction")
    out += guidance_table("guidance", "guidance")
    out += _pre_aggregation_table()
    for i in range(num_sga):
        out += guided_block_table(f"sga{i}", f"sga{i}")
        out += classifier_table(f"classif_sga{i}", f"classif_sga{i}")
    if use_lga:
        out += guided_block_table("lga", "lga")
    out += classifier_table("classif_final", "classif_final")
    out += propagation_table("prop", "prop")
    return out


# ---- nn/extras.py and nn/context.py (no reference layout: the port's names)

def conv2d_bn_relu_table(tp: str, fp: str, use_bias: bool = True, with_bn: bool = True) -> List[Entry]:
    out = [(_t(tp, "conv.weight"), _f(fp, "Conv_0/kernel"), "conv2d")]
    if use_bias:
        out.append((_t(tp, "conv.bias"), _f(fp, "Conv_0/bias"), "bias"))
    if with_bn:
        out.append((_t(tp, "bn"), _f(fp, "BatchNorm_0/BatchNorm_0"), "bn"))
    return out


def pyramid_pooling_table(tp: str, fp: str, n_paths: int, with_bn: bool = True) -> List[Entry]:
    out = []
    for i in range(n_paths):
        out += conv2d_bn_relu_table(_t(tp, f"paths.{i}"), _f(fp, f"Conv2DBatchNormRelu_{i}"), not with_bn, with_bn)
    return out


def mobile_v2_table(tp: str, fp: str, expand: bool) -> List[Entry]:
    """MobileV2Residual's `conv` Sequential: [expand conv, BN, ReLU6,]
    depthwise conv, BN, ReLU6, project conv, BN."""
    convs = (0, 3, 6) if expand else (0, 3)
    out = []
    for i, seq in enumerate(convs):
        out += [
            (_t(tp, f"conv.{seq}.weight"), _f(fp, f"Conv_{i}/kernel"), "conv2d"),
            (_t(tp, f"conv.{seq + 1}"), _f(fp, f"BatchNorm_{i}/BatchNorm_0"), "bn"),
        ]
    return out


def hourglass2d_table(tp: str, fp: str) -> List[Entry]:
    out = []
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4", "redir2", "redir1")):
        out += mobile_v2_table(_t(tp, name), _f(fp, f"MobileV2Residual_{i}"), expand=True)
    for i, name in enumerate(("conv5", "conv6")):
        out += [
            (_t(tp, f"{name}.0.weight"), _f(fp, f"TorchConvTranspose_{i}/kernel"), "deconv2d"),
            (_t(tp, f"{name}.1"), _f(fp, f"BatchNorm_{i}/BatchNorm_0"), "bn"),
        ]
    return out


def unet_feature_table(tp: str, fp: str) -> List[Entry]:
    names = ("stem.0", "stem.1", "stem.2", "down4", "down8", "down16", "psp_fuse", "dec8", "dec4")
    out = []
    for i, name in enumerate(names):
        out += conv2d_bn_relu_table(_t(tp, name), _f(fp, f"Conv2DBatchNormRelu_{i}"))
    out += pyramid_pooling_table(_t(tp, "psp"), _f(fp, "PyramidPooling_0"), 4)
    out.append((_t(tp, "lastconv.weight"), _f(fp, "Conv_0/kernel"), "conv2d"))
    return out


def image_level_context_table(tp: str, fp: str, concat_input: bool = True) -> List[Entry]:
    out = attention_table(_t(tp, "cross_attention"), _f(fp, "cross_attention"))
    if concat_input:
        out += convbn_table(_t(tp, "bottleneck.0"), _f(fp, "bottleneck/ConvBN_0"), 3)
    return out


def fc_table(tp: str, fp: str, bias: bool) -> List[Entry]:
    """Linears fc1, fc2 <-> flax Dense_0, Dense_1 (DisparityLevelContext
    with biases, SELayerD without)."""
    out = []
    for i, name in enumerate(("fc1", "fc2")):
        out.append((_t(tp, f"{name}.weight"), _f(fp, f"Dense_{i}/kernel"), "dense"))
        if bias:
            out.append((_t(tp, f"{name}.bias"), _f(fp, f"Dense_{i}/bias"), "bias"))
    return out


def semantic_level_context_local_table(tp: str, fp: str) -> List[Entry]:
    out = convbn_table(_t(tp, "agg.0"), _f(fp, "agg/ConvBN_0"), 3)
    out += attention_table(_t(tp, "cross_attention"), _f(fp, "cross_attention"))
    return out


def _extras_table(module: nn.Module) -> List[Entry]:
    """The table of an `nn/extras.py` or `nn/context.py` module, read off its
    structure; raises TypeError for any other module."""
    from dcanet_tpu_torch.nn import context as C
    from dcanet_tpu_torch.nn import extras as X

    if isinstance(module, X.Conv2DBatchNormRelu):
        return conv2d_bn_relu_table("", "", module.conv.bias is not None, module.bn is not None)
    if isinstance(module, X.PyramidPooling):
        return pyramid_pooling_table("", "", len(module.paths), module.paths[0].bn is not None)
    if isinstance(module, X.MobileV2Residual):
        return mobile_v2_table("", "", expand=len(module.conv) == 8)
    if isinstance(module, X.Hourglass2D):
        return hourglass2d_table("", "")
    if isinstance(module, X.UNetFeatureExtractor):
        return unet_feature_table("", "")
    if isinstance(module, C.NonLocalAttention):
        return attention_table("", "")
    if isinstance(module, C.ImageLevelContext):
        return image_level_context_table("", "", module.bottleneck is not None)
    if isinstance(module, C.DisparityLevelContext):
        return fc_table("", "", bias=True)
    if isinstance(module, C.SELayerD):
        return fc_table("", "", bias=False)
    if isinstance(module, C.SemanticLevelContextLocal):
        return semantic_level_context_local_table("", "")
    raise TypeError(f"no key table for {type(module).__name__}")


ModelRef = Union[int, str, nn.Module]


def model_table(model: ModelRef = 3) -> List[Entry]:
    """The key table of a port model: the model itself, its registry name, or
    an int, read as the `num_cva` of DCANet with its concat volume; or a
    module of `nn/extras.py` / `nn/context.py`."""
    from dcanet_tpu_torch.models import DCANet, GANetStereo, GwcNetBaseline
    from dcanet_tpu_torch.models.registry import make_model

    if isinstance(model, int):
        return dcanet_table(model)
    if isinstance(model, str):
        model = make_model(model)
    if isinstance(model, DCANet):
        return dcanet_table(model.num_cva, model.use_concat_volume)
    if isinstance(model, GwcNetBaseline):
        return gwcnet_table(model.use_concat_volume)
    if isinstance(model, GANetStereo):
        return ganet_table(model.num_sga, model.use_lga)
    return _extras_table(model)


# flax -> torch layouts, and their inverses
_TO_TORCH = {
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "conv3d": lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
    "deconv3d": lambda w: np.transpose(w, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1],
    "deconv2d": lambda w: np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1],
    "dense": lambda w: np.transpose(w, (1, 0)),
    "bias": lambda w: w,
}
_TO_FLAX = {
    "conv2d": lambda w: np.transpose(w, (2, 3, 1, 0)),
    "conv3d": lambda w: np.transpose(w, (2, 3, 4, 1, 0)),
    "deconv3d": lambda w: np.transpose(w[:, :, ::-1, ::-1, ::-1], (2, 3, 4, 0, 1)),
    "deconv2d": lambda w: np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)),
    "dense": lambda w: np.transpose(w, (1, 0)),
    "bias": lambda w: w,
}
_BN = (("weight", "params", "scale"), ("bias", "params", "bias"),
       ("running_mean", "batch_stats", "mean"), ("running_var", "batch_stats", "var"))


def _pairs(table: List[Entry]):
    """(torch key, flax key, kind) per tensor, BN entries expanded."""
    for tkey, fpath, kind in table:
        if kind == "bn":
            for tname, coll, fname in _BN:
                yield f"{tkey}.{tname}", f"{coll}/{fpath}/{fname}", "bias"
        else:
            yield tkey, f"params/{fpath}", kind


def state_dict_from_flax(flat: Mapping[str, np.ndarray], table: List[Entry]) -> Dict[str, torch.Tensor]:
    """Convert flat flax variables by `table`. Raises KeyError if a path of the
    table is missing, ValueError if a flax parameter or statistic is left over."""
    sd, used = {}, set()
    for tkey, fkey, kind in _pairs(table):
        if fkey not in flat:
            raise KeyError(f"missing flax variable {fkey} (for {tkey})")
        arr = np.asarray(flat[fkey], dtype=np.float32)
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(_TO_TORCH[kind](arr)))
        used.add(fkey)
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"{len(left)} flax variables have no port counterpart, e.g. {left[:5]}")
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor], table: List[Entry]) -> Dict[str, np.ndarray]:
    """Inverse of `state_dict_from_flax` (num_batches_tracked is dropped)."""
    out = {}
    for tkey, fkey, kind in _pairs(table):
        arr = sd[tkey].detach().cpu().float().numpy()
        out[fkey] = np.ascontiguousarray(_TO_FLAX[kind](arr))
    return out


def from_jax_variables(flat: Mapping[str, np.ndarray], model: ModelRef = 3) -> Dict[str, torch.Tensor]:
    """Flat flax variables of a dcanet_tpu model -> a state_dict that the
    port's counterpart loads with strict=True; `model` as `model_table` takes
    it. A flax DCANet must own classif0..classif{num_cva} (an init with
    train=True does)."""
    return state_dict_from_flax(flat, model_table(model))


def to_jax_variables(sd: Mapping[str, torch.Tensor], model: ModelRef = 3) -> Dict[str, np.ndarray]:
    """A port model's state_dict -> flat flax variables."""
    return flax_from_state_dict(sd, model_table(model))


# The reference's stride-2 ResidualBlock registers its downsample BN twice,
# as `norm3` and as `downsample.1`; the port keeps the second name only.
_ALIAS = re.compile(r"^(.*)\.norm3\.(.*)$")


def load_reference_checkpoint(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A reference torch checkpoint (`torch.save` dict with a `state_dict`,
    keys prefixed `module.`) -> a state_dict for the port's DCANet: the
    prefix stripped, `num_batches_tracked` and the `norm3` aliases dropped."""
    return _from_reference_payload(torch.load(path, map_location="cpu", weights_only=True))


def _from_reference_payload(payload: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    sd = payload.get("state_dict", payload)
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    out = {}
    for k, v in sd.items():
        m = _ALIAS.match(k)
        if m and f"{m.group(1)}.downsample.1.{m.group(2)}" in sd:
            continue
        out[k] = v
    return out


def load_weights(path: Union[str, Path], model: ModelRef = 3) -> Dict[str, torch.Tensor]:
    """`.npz` of flat flax variables of `model` (as `model_table` takes it);
    a checkpoint of the port's `cli train` (`train.checkpoint.
    CheckpointManager`: the weights under `"model"`); or a reference-keyed
    torch checkpoint (`"state_dict"`, `module.` prefixes)."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            return from_jax_variables({k: f[k] for k in f.files}, model)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in payload:
        return dict(payload["model"])
    return _from_reference_payload(payload)
