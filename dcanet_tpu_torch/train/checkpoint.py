"""Checkpoints of the whole train state, and params-only weights (port of
dcanet_tpu/train/checkpoint.py:20-87, with torch.save in place of Orbax).

A full checkpoint holds the model's state_dict (parameters and BatchNorm
statistics), the optimizer's state and the step, so a resumed run continues
where it stopped (the reference restored weights only, main_dca.py:249).
`save_params_only` / `load_params_only` carry the weights alone, for
`--loadckpt` fine-tuning (optimizer and step start fresh).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Union

import torch
from torch import nn

from dcanet_tpu_torch.train.state import TrainState

PathLike = Union[str, Path]
_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def checkpoint_steps(directory: PathLike) -> List[int]:
    """Steps of the `ckpt_<step>.pt` files in `directory`, oldest first; []
    when it does not exist. Reads only: creates nothing."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for p in directory.iterdir() if (m := _NAME.match(p.name)))


def checkpoint_step(path: PathLike) -> int:
    """The step in the name of a `ckpt_<step>.pt` file."""
    return int(_NAME.match(Path(path).name).group(1))


def latest_checkpoint(directory: PathLike) -> Optional[Path]:
    """Path of the newest `ckpt_<step>.pt` in `directory`, or None."""
    steps = checkpoint_steps(directory)
    return Path(directory) / f"ckpt_{steps[-1]:08d}.pt" if steps else None


def _save(payload: dict, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """`directory/ckpt_<step>.pt`, the newest `max_to_keep` kept."""

    def __init__(self, directory: PathLike, max_to_keep: int = 5):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        return checkpoint_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metrics: Optional[dict] = None) -> int:
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "metrics": metrics or {},
        }
        _save(payload, self.directory / f"ckpt_{state.step:08d}.pt")
        for old in self.steps()[: -self.max_to_keep]:
            (self.directory / f"ckpt_{old:08d}.pt").unlink()
        return state.step

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load model, optimizer and step into `state` (in place); returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self.directory / f"ckpt_{step:08d}.pt", map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state


def save_params_only(path: PathLike, model: nn.Module) -> None:
    """Weights only: parameters and BatchNorm statistics."""
    _save({"state_dict": model.state_dict()}, Path(path))


def export_params_only(checkpoint: PathLike, path: PathLike) -> None:
    """The weights of a full checkpoint (its "model") as `save_params_only`
    writes them."""
    payload = torch.load(checkpoint, map_location="cpu", weights_only=True)
    _save({"state_dict": payload["model"]}, Path(path))


def load_params_only(path: PathLike, model: nn.Module) -> nn.Module:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    return model
