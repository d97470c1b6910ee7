"""Model FLOPs of the requests served in the traced window (`flops.py`:
convolutions, matrix products and the scan's recurrence, from the
configuration and the bucket shape) over the window's time times the
configuration's stated peak, in percent. Layer: the model
(`models/wavemamba.py`)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"] or not ctx["trace"].device_ops:
        return None
    done = ctx["flops_per_request"] * ctx["requests"]
    return 100.0 * done / (ctx["trace"].window_s * ctx["peak_flops"])
