"""The names behind `cli --model` (the port's own copy of
dcanet_tpu/models/registry.py): the released DCANet, its ablations by CVA
count and without the concat volume, the plain GwcNet baselines and the
GANet-style network.

`remat` belongs to the DCANet family; the other families raise a ValueError
that names the model when it is asked for. So does `constrain_volume` (a
disparity-sharding plan, `parallel.make_disp_constraint`): the other
families' constructors do not take it and raise a TypeError, as their flax
modules do."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from dcanet_tpu_torch.models.dcanet import DCANet, GwcNetBaseline
from dcanet_tpu_torch.models.ganet import GANetStereo


def _dca(num_cva: int, use_concat: bool = True, full_res: bool = False) -> Callable[..., nn.Module]:
    def factory(maxdisp: int = 192, **kw: Any) -> DCANet:
        return DCANet(maxdisp=maxdisp, num_cva=num_cva, use_concat_volume=use_concat, full_res_supervision=full_res,
                      **kw)

    return factory


def _no_remat(name: str, cls: Callable[..., nn.Module], **fixed: Any) -> Callable[..., nn.Module]:
    def factory(maxdisp: int = 192, remat: bool = False, **kw: Any) -> nn.Module:
        if remat:
            raise ValueError(f"model {name!r} has no remat (only the DCANet family checkpoints its blocks)")
        return cls(maxdisp=maxdisp, **fixed, **kw)

    return factory


MODELS: Dict[str, Callable[..., nn.Module]] = {
    "dcanet": _dca(3),  # flagship (reference gwcnet_dca_g.py)
    "dcanet-g": _dca(3, use_concat=False),
    "dcanet-cva0": _dca(0),
    "dcanet-cva1": _dca(1),
    "dcanet-cva2": _dca(2),
    "dcanet-cva4": _dca(4, full_res=True),  # reference gwcnet_dca4_g.py
    "gwcnet-g": _no_remat("gwcnet-g", GwcNetBaseline, use_concat_volume=False),  # reference gwcnet.py
    "gwcnet-gc": _no_remat("gwcnet-gc", GwcNetBaseline, use_concat_volume=True),
    "ganet": _no_remat("ganet", GANetStereo),
}


def make_model(name: str, maxdisp: int = 192, **kw: Any) -> nn.Module:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](maxdisp=maxdisp, **kw)
