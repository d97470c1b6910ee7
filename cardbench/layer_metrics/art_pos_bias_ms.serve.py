"""Host time a request in the program's span `wm.art.pos_bias`
(`models/art.py:Attention.bias_rows`: the position-bias MLP over a group's
offsets and its gather into the (heads, N, N) bias, once an attention call):
the span's summed duration over the traced window, over the requests
traced, in ms. Nothing is read where the trace holds no such span. Layer:
host dispatch."""

SPAN = "wm.art.pos_bias"


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"]:
        return None
    ns = [e - s for n, s, e in ctx["trace"].host_ops if n == SPAN]
    return 1e-6 * sum(ns) / ctx["requests"] if ns else None
