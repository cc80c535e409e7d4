"""features_ms.serve_bf16: the device time of the modules the configuration maps to
the layer `features` (the 2D feature extractor), in ms per forward (CUDA
events in the benchmark's hooks)."""


def read(ctx):
    return ctx.get("spans", {}).get("layers_ms", {}).get("features")
