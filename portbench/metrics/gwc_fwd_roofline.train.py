"""gwc_fwd_roofline.train: the gwc forward kernel's share of its roofline at the
train shape, from the trace's kernel time by name."""

from portbench.lib.readers import gwc_roofline


def read(ctx):
    return gwc_roofline(ctx, backward=False)
