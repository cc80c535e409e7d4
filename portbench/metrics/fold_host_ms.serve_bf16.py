"""fold_host_ms.serve_bf16: the host's time in the BatchNorm fold's gate and cache
lookup at every folded conv_bn site (accumulator fold.lookup in
nn/layers.py::conv_bn), in ms per request; from the program's spans in the
traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("fold.lookup", "serve.request", "host_ms")
