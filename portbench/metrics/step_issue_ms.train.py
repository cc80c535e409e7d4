"""step_issue_ms.train: the host's time to issue one train step, from train_step's
call to its return (span train.step), in ms per step; from the program's spans
in the traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("train.step", "train.step", "host_ms")
