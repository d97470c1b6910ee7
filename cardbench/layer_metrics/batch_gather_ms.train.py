"""Host time a step in the program's span `wm.data.batch`
(`data/device_cache.py:DeviceCachedLoader.__iter__`: the index draw and the
gather on the card): the span's summed duration over the traced window,
over the steps traced, in ms. Nothing is read where the trace holds no such
span. Layer: data."""

SPAN = "wm.data.batch"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    ns = [e - s for n, s, e in ctx["trace"].host_ops if n == SPAN]
    return 1e-6 * sum(ns) / ctx["steps"] if ns else None
