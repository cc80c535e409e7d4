"""cost_volume_ms.serve_bf16: the device time of the cost volume, the gwc kernel
and the concat volume (span model.cost_volume in models/dcanet.py::cost_volume,
CUDA events), in ms per request; from the program's spans in the traced
stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("model.cost_volume", "serve.request", "device_ms")
