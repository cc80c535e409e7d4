"""Models of the port."""

from dcanet_tpu_torch.models.dcanet import DCANet, DCANetEvalOutput, DCANetTrainOutput

__all__ = ["DCANet", "DCANetEvalOutput", "DCANetTrainOutput"]
