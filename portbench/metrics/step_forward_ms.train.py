"""step_forward_ms.train: the device time of the train step's forward (span
model.forward, CUDA events), in ms per step; from the program's spans in the
traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("model.forward", "train.step", "device_ms")
