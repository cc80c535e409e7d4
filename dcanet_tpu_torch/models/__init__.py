"""Models of the port."""

from dcanet_tpu_torch.models.dcanet import DCANet, DCANetEvalOutput

__all__ = ["DCANet", "DCANetEvalOutput"]
