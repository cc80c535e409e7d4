"""optimizer_ms.train: the device time of the gradient's global norm and the Adam
update (span train.optimizer, CUDA events), in ms per step; from the program's
spans in the traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("train.optimizer", "train.step", "device_ms")
