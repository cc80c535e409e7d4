"""host_issue_ms.serve_bf16: the host's time from a forward's entry to its return, in
ms, the mean over the window's forwards (host clock in the benchmark's hooks)."""


def read(ctx):
    return ctx.get("spans", {}).get("host_issue_ms")
