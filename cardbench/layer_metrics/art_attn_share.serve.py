"""The device time of ART's attention kernels (the kernels whose name holds
`fmha` or `attention`) over the traced busy time (the union of all device
operations), in percent. Nothing is read where the trace holds no such
kernel. Layer: the model (`models/art.py`)."""


def _is_attention(name):
    low = name.lower()
    return "fmha" in low or "attention" in low


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["trace"].device_ops:
        return None
    trace = ctx["trace"]
    seconds = trace.device_s(_is_attention)
    busy = trace.busy_s()
    return 100.0 * seconds / busy if seconds and busy else None
