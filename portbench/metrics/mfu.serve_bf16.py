"""mfu.serve_bf16: the whole request's operations, counted once from the reference, at
the window's rate of pairs, against the peak of the cell's dtype."""

from portbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
