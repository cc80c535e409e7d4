"""d2h_wait_ms.serve_bf16: the host's time blocked bringing the disparity back,
which waits for the forward to end (span serve.d2h in cli._forward), in ms per
request; from the program's spans in the traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("serve.d2h", "serve.request", "host_ms")
