"""forward_ms.serve: the device time from a forward's entry to its exit, in ms,
the mean over the window's forwards (CUDA events in the benchmark's hooks)."""


def read(ctx):
    return ctx.get("spans", {}).get("forward_ms")
