"""step_backward_ms.train: the device time of the train step's backward (span
train.backward around loss.backward(), CUDA events), in ms per step; from the
program's spans in the traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("train.backward", "train.step", "device_ms")
