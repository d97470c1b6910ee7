"""The share of the traced window in which no device operation ran: 1 minus
the union of the kernel, copy and fill intervals over the window, in
percent. Layer: the device."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"].device_ops:
        return None
    trace = ctx["trace"]
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
