"""idle_pct.train: the share of the traced steps' stretch in which no
device operation ran (the union of their intervals, not their sum)."""

from portbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
