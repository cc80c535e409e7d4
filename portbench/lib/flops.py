"""The operations of a request or a step, counted once from the reference.

torch.utils.flop_counter counts the convolutions, transposed convolutions
and matrix products (the einsums) of the plain reference network on the
meta device at the cell's shapes: the same count whatever implements the
work, and no device time spent. Elementwise work (BatchNorm, softmax, the
correlation's products) is not counted, so an `mfu` reads low, never high.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import stereo


def count(config: dict, batch: int, hw, train: bool) -> int:
    """Operations of one forward (train: forward and backward) of `batch`
    pairs of size hw through the configuration's reference network."""
    with torch.device("meta"):
        model = stereo.from_config(config)
        left = torch.empty(batch, 3, *hw)
        right = torch.empty(batch, 3, *hw)
    model.train(train)
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            probs, disps = model(left, right)
            loss = sum(p.sum() for p in probs) + sum(d.sum() for d in disps)
            loss.backward()
        else:
            with torch.no_grad():
                model(left, right)
    return int(counter.get_total_flops())
