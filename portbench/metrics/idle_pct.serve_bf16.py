"""idle_pct.serve_bf16: the share of the traced requests' stretch in which no device
operation ran (the union of their intervals, not their sum)."""

from portbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
