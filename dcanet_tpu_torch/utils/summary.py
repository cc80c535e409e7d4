"""Model summary (port of dcanet_tpu/utils/summary.py; the reference vendors
a torchsummary clone, models/lib/torchsummary.py): parameter counts and a
layer table built from forward hooks, the counterpart of flax's `tabulate`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

import torch
from torch import nn

from dcanet_tpu_torch.device import resolve_device
from dcanet_tpu_torch.nn.layers import frozen_bn_statistics

_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def count_params(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """The number of parameters: a module's `parameters()`, or the entries of
    a state_dict less BatchNorm's statistics (the JAX package counts the
    `params` collection, not `batch_stats`)."""
    if isinstance(model_or_state_dict, nn.Module):
        return sum(p.numel() for p in model_or_state_dict.parameters())
    return sum(v.numel() for k, v in model_or_state_dict.items() if k.rsplit(".", 1)[-1] not in _STATISTICS)


def _shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return str(tuple(out.shape))
    if dataclasses.is_dataclass(out):
        out = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}
    if isinstance(out, Mapping):
        return "{" + ", ".join(f"{k}: {_shape(v)}" for k, v in out.items()) + "}"
    if isinstance(out, (list, tuple)):
        return "[" + ", ".join(_shape(v) for v in out) + "]"
    return type(out).__name__


def summarize(model: nn.Module, input_hw: Tuple[int, int] = (64, 128), train: bool = True, depth: int = 2,
              device: Optional[Union[str, torch.device]] = None) -> str:
    """A table of a stereo model taking (left, right): each module down to
    `depth` levels below the model, in the order of its first call, with its
    type, output shape and parameter count, and the totals. It runs one
    forward on a zero 1x3xHxW pair in train or eval mode on `device` (CUDA
    unless the caller asks for another; the model is moved there), with the
    BatchNorm statistics left as they were and the model's mode restored."""
    dev = resolve_device(device)
    rows = {}  # path -> [type, output shape, params], in order of first call
    handles = []
    for path, module in model.named_modules():
        if path.count(".") + 1 > depth and path:
            continue

        def first_call(mod, args, path=path):
            rows.setdefault(path, [type(mod).__name__, "", count_params(mod)])

        def output(mod, args, out, path=path):
            rows[path][1] = _shape(out)

        handles += [module.register_forward_pre_hook(first_call), module.register_forward_hook(output)]
    was_training = model.training
    h, w = input_hw
    zeros = torch.zeros(1, 3, h, w, device=dev)
    try:
        model.to(dev).train(train)
        with torch.no_grad(), frozen_bn_statistics():
            model(zeros, zeros)
    finally:
        for hd in handles:
            hd.remove()
        model.train(was_training)
    lines = [("module", "type", "output shape", "params")]
    lines += [(path or "(model)", *(str(v) for v in row)) for path, row in rows.items()]
    widths = [max(len(line[i]) for line in lines) for i in range(3)]
    text = ["  ".join(line[i].ljust(widths[i]) for i in range(3)) + "  " + line[3] for line in lines]
    n_stats = sum(b.numel() for name, b in model.named_buffers() if name.rsplit(".", 1)[-1] in _STATISTICS)
    text.append(f"total params: {count_params(model):,}; BatchNorm statistics: {n_stats:,}")
    return "\n".join(text)
