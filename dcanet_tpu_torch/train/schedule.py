"""Learning-rate schedules as per-step functions, and Adam (port of
dcanet_tpu/train/schedule.py; reference util.py:89-145, main_dca.py:64).

Each schedule maps the optimizer step k (0 for the first update) to the LR
that optax's schedule of the same name gives at k: optax's
piecewise_constant_schedule multiplies in the scale of every boundary b
with k >= b, so a new LR applies from step b on.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

LRFunction = Callable[[int], float]


def parse_lr_spec(spec: str) -> Tuple[list, float]:
    """'12,20,24,28:2' -> ([12, 20, 24, 28], 2.0)."""
    epochs_str, gamma_str = spec.split(":")
    return [int(e) for e in epochs_str.split(",")], float(gamma_str)


def _piecewise_constant(init_value: float, boundaries_and_scales: Dict[int, float]) -> LRFunction:
    items = sorted(boundaries_and_scales.items())

    def lr(step: int) -> float:
        value = init_value
        for boundary, scale in items:
            if step >= boundary:
                value *= scale
        return value

    return lr


def epoch_decay_schedule(base_lr: float, spec: str, steps_per_epoch: int) -> LRFunction:
    """The reference's adjust_learning_rate: divide by gamma at each listed epoch."""
    epochs, gamma = parse_lr_spec(spec)
    return _piecewise_constant(base_lr, {e * steps_per_epoch: 1.0 / gamma for e in epochs})


def piecewise_lr_schedule(values: Sequence[float], boundaries_epochs: Sequence[int], steps_per_epoch: int) -> LRFunction:
    """Explicit levels, e.g. ([1e-3, 1e-4, 1e-5], [300, 600])."""
    if len(values) != len(boundaries_epochs) + 1:
        raise ValueError(f"{len(values)} levels for {len(boundaries_epochs)} boundaries")
    return _piecewise_constant(
        values[0], {b * steps_per_epoch: values[i + 1] / values[i] for i, b in enumerate(boundaries_epochs)}
    )


def kitti_finetune_schedule(steps_per_epoch: int) -> LRFunction:
    """util.py:132-145: 1e-3 until epoch 300, 1e-4 until 600, then 1e-5."""
    return piecewise_lr_schedule([1e-3, 1e-4, 1e-5], [300, 600], steps_per_epoch)


def make_adam(params, lr_fn: LRFunction) -> torch.optim.Adam:
    """Adam(betas=(0.9, 0.999), eps=1e-8), as optax.adam and main_dca.py:64.
    Its LR is set from `lr_fn` before every step (train/state.py)."""
    return torch.optim.Adam(params, lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8)
