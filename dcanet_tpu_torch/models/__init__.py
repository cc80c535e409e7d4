"""Models of the port."""

from dcanet_tpu_torch.models.dcanet import DCANet, DCANetEvalOutput, DCANetTrainOutput, GwcNetBaseline
from dcanet_tpu_torch.models.ganet import GANetStereo

__all__ = ["DCANet", "DCANetEvalOutput", "DCANetTrainOutput", "GANetStereo", "GwcNetBaseline"]
