"""The names behind `cli --model` (the port's own copy of
dcanet_tpu/models/registry.py): the released DCANet and its ablations by CVA
count. The JAX package's other names raise a ValueError that says which
ROADMAP item ports them."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from dcanet_tpu_torch.models.dcanet import DCANet


def _dca(num_cva: int, full_res: bool = False) -> Callable[..., nn.Module]:
    def factory(maxdisp: int = 192, **kw: Any) -> DCANet:
        return DCANet(maxdisp=maxdisp, num_cva=num_cva, full_res_supervision=full_res, **kw)

    return factory


MODELS: Dict[str, Callable[..., nn.Module]] = {
    "dcanet": _dca(3),  # flagship (reference gwcnet_dca_g.py)
    "dcanet-cva0": _dca(0),
    "dcanet-cva1": _dca(1),
    "dcanet-cva2": _dca(2),
    "dcanet-cva4": _dca(4, full_res=True),  # reference gwcnet_dca4_g.py
}

NOT_PORTED = {
    "dcanet-g": "DCANet without the concat volume (use_concat_volume=False): ROADMAP Queue 1 item 2, still open",
    "gwcnet-g": "GwcNetBaseline: ROADMAP Queue 1 item 3",
    "gwcnet-gc": "GwcNetBaseline: ROADMAP Queue 1 item 3",
    "ganet": "the GANet family: ROADMAP Queue 1 item 5",
}


def make_model(name: str, maxdisp: int = 192, **kw: Any) -> nn.Module:
    if name in NOT_PORTED:
        raise ValueError(f"model {name!r} is not ported yet ({NOT_PORTED[name]}); ported: {sorted(MODELS)}")
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](maxdisp=maxdisp, **kw)
