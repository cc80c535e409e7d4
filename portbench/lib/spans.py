"""Spans around the program's model, taken from the benchmark's own hooks.

`ForwardSpans(model, layers)` hooks the model's forward and the submodules
that a configuration's `layers` map names to a layer: a host clock reading
and a CUDA event at each forward's entry and exit, and a CUDA event pair
around each mapped submodule. `summary()` (after a synchronize) gives, per
forward, the host's time to issue it, the device time from its entry to its
exit, and each layer's device time: the means over all forwards.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch


class ForwardSpans:
    def __init__(self, model: torch.nn.Module, layers: Dict[str, str]):
        self.forwards: List[dict] = []
        self._handles = [model.register_forward_pre_hook(self._enter),
                         model.register_forward_hook(self._exit)]
        modules = dict(model.named_modules())
        for name, layer in layers.items():
            if name not in modules:
                raise KeyError(f"the layer map names {name!r}, which the model does not have")
            self._handles += [modules[name].register_forward_pre_hook(self._layer_enter(layer)),
                              modules[name].register_forward_hook(self._layer_exit(layer))]

    @staticmethod
    def _event() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _enter(self, module, args):
        self.forwards.append({"host0": time.perf_counter(), "ev0": self._event(), "layers": []})

    def _exit(self, module, args, output):
        f = self.forwards[-1]
        f["ev1"] = self._event()
        f["host1"] = time.perf_counter()

    def _layer_enter(self, layer: str):
        def hook(module, args):
            if self.forwards:
                self.forwards[-1]["layers"].append([layer, self._event(), None])
        return hook

    def _layer_exit(self, layer: str):
        def hook(module, args, output):
            if self.forwards:
                open_spans = [s for s in self.forwards[-1]["layers"] if s[0] == layer and s[2] is None]
                open_spans[-1][2] = self._event()
        return hook

    def remove(self) -> None:
        for h in self._handles:
            h.remove()

    def summary(self) -> dict:
        """Means over the forwards, in ms: host_issue, forward and each layer's."""
        torch.cuda.synchronize()
        done = [f for f in self.forwards if "ev1" in f]
        if not done:
            return {}
        out = {"forwards": len(done),
               "host_issue_ms": sum(1e3 * (f["host1"] - f["host0"]) for f in done) / len(done),
               "forward_ms": sum(f["ev0"].elapsed_time(f["ev1"]) for f in done) / len(done),
               "layers_ms": {}}
        for f in done:
            for layer, a, b in f["layers"]:
                out["layers_ms"][layer] = out["layers_ms"].get(layer, 0.0) + a.elapsed_time(b) / len(done)
        return out
