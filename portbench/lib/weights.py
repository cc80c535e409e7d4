"""Seeded weights for a network, drawn on its device in one call.

Every floating leaf of the reference network's state_dict is cut from one
normal draw of a `torch.Generator` on the device, then scaled by its kind:
convolution kernels normal(0, sqrt(2 / fan_in)) (He's init: a ReLU layer
keeps its input's scale; a transposed convolution of stride s reaches each
output from kernel points / s of its inputs), convolution biases,
BatchNorm scales and shifts and running means at 0.05 around 1 or 0,
running variances 1 + 0.1 |z|. The published init scales by fan_out
instead, which leaves the 1-channel cost heads' logits about five times as
wide and their softmax over D near one-hot: a served disparity then jumps
between distant planes on rounding, in the reference as in the program.
The same seed gives the same weights to the program and to the reference,
which both load them. `serving_weights` then sets the BatchNorm running
statistics from the reference on a pair (lib/inputs.py), as a trained
network's are: with the random ones an eval forward's activations double
at every residual add.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from portbench.reference import stereo

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_DECONVS = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)
BRANCH_SCALE = 0.2  # the scale of a BatchNorm that ends a residual branch


def _leaf_rules(model: nn.Module) -> Dict[str, tuple]:
    """name -> (scale, offset, absolute) for every floating leaf."""
    rules = {}
    for prefix, m in model.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, _CONVS + _DECONVS):
            points = math.prod(m.weight.shape[2:])
            if isinstance(m, _DECONVS):
                fan_in = m.weight.shape[0] * points / math.prod(m.stride)
            else:
                fan_in = m.weight.shape[1] * points
            rules[p + "weight"] = (math.sqrt(2.0 / fan_in), 0.0, False)
            if m.bias is not None:
                rules[p + "bias"] = (0.05, 0.0, False)
        elif isinstance(m, _NORMS):
            scale = BRANCH_SCALE if getattr(m, "ends_branch", False) else 1.0
            rules[p + "weight"] = (0.05 * scale, scale, False)
            rules[p + "bias"] = (0.05, 0.0, False)
            rules[p + "running_mean"] = (0.05, 0.0, False)
            rules[p + "running_var"] = (0.1, 1.0, True)
    return rules


def seeded_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state_dict for `model`'s keys, float32 on `device`, from `seed`."""
    rules = _leaf_rules(model)
    sd = model.state_dict()
    names = [k for k, v in sd.items() if v.is_floating_point()]
    missing = [k for k in names if k not in rules]
    if missing:
        raise KeyError(f"no rule for the leaves {missing[:5]}")
    counts = torch.tensor([sd[k].numel() for k in names], device=device)
    spec = torch.tensor([rules[k][:2] for k in names], dtype=torch.float32, device=device)
    absolute = torch.tensor([rules[k][2] for k in names], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(int(counts.sum()), generator=gen, device=device, dtype=torch.float32)
    z = torch.where(absolute.repeat_interleave(counts), z.abs(), z)
    flat = spec[:, 1].repeat_interleave(counts) + spec[:, 0].repeat_interleave(counts) * z
    out = {k: t.view(sd[k].shape) for k, t in zip(names, flat.split(counts.tolist()))}
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
    return out


def serving_weights(layout: nn.Module, net: nn.Module, seed: int, left: torch.Tensor, right: torch.Tensor,
                    device) -> Dict[str, torch.Tensor]:
    """The seeded weights with the BatchNorm running statistics of the
    reference `net` (on `device`, float32, TF32 off) over the pair (left,
    right): each BatchNorm's mean and variance of its input there."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net.load_state_dict(seeded_state_dict(layout, seed, device))
    stereo.calibrate_bn_(net, left, right)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def load_into_program(model: nn.Module, state: Dict[str, torch.Tensor], config: dict) -> nn.Module:
    """`state` into the program's model, strictly. The weights were drawn for
    the reference built from the configuration file's widths
    (`stereo.from_config`), so every parameter's shape holds the program to
    them; the widths no parameter shows are read off the model. A program
    that runs other widths than the file states is refused."""
    model.load_state_dict(state, strict=True)
    for key in ("maxdisp", "num_groups", "num_cva"):
        if key in config and getattr(model, key, None) != config[key]:
            raise ValueError(f"the program's {key} is {getattr(model, key, None)!r}; "
                             f"the configuration states {config[key]!r}")
    return model
