"""h2d_ms.serve: the host's time in the request's two uploads and the synchronize
after them (span serve.h2d in cli._forward), in ms per request; from the
program's spans in the traced stretch."""

from portbench.lib.program_spans import per_root


def read(ctx):
    return per_root("serve.h2d", "serve.request", "host_ms")
