"""Train state: the model (parameters and BatchNorm statistics), its Adam
optimizer, the per-step LR function and the step count (port of
dcanet_tpu/train/state.py; the JAX package's TrainState is one pytree, here
the model and optimizer are updated in place).

`amp_dtype` is the autocast type of the forward (`torch.bfloat16` for the
JAX package's dtype=bfloat16: bf16 compute over f32 parameters), or None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from dcanet_tpu_torch.train.schedule import LRFunction, make_adam


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: LRFunction
    step: int = 0
    amp_dtype: Optional[torch.dtype] = None

    def apply_gradients(self) -> None:
        """One Adam update at the LR of this step (optax's schedule(step))."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, lr_fn: LRFunction, amp_dtype: Optional[torch.dtype] = None) -> TrainState:
    return TrainState(model=model, optimizer=make_adam(model.parameters(), lr_fn), lr_fn=lr_fn, amp_dtype=amp_dtype)
