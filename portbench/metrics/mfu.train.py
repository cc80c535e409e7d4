"""mfu.train: the whole step's operations (forward and backward), counted once
from the reference, at the window's rate of steps, against the peak of the
cell's dtype."""

from portbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
