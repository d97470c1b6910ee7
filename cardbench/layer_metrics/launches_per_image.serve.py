"""Device operations (kernels, copies, fills) per request in the traced
window. Layer: host dispatch (`models/wavemamba.py`, `ops/nn.py`)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"] or not ctx["trace"].device_ops:
        return None
    return len(ctx["trace"].device_ops) / ctx["requests"]
