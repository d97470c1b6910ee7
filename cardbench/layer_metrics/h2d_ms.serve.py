"""Host time a request in the program's span `wm.enhance.h2d`
(`inference.enhance`: the contiguous copy, `torch.from_numpy` and the copy
to the card): the span's summed duration over the traced window, over the
requests traced, in ms. Nothing is read where the trace holds no such span.
Layer: the request path."""

SPAN = "wm.enhance.h2d"


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"]:
        return None
    ns = [e - s for n, s, e in ctx["trace"].host_ops if n == SPAN]
    return 1e-6 * sum(ns) / ctx["requests"] if ns else None
