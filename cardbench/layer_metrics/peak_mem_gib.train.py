"""`torch.cuda.max_memory_allocated()` over the window, after
`reset_peak_memory_stats()` at its start, in GiB. Layer: the device."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["window_peak_bytes"]:
        return None
    return ctx["window_peak_bytes"] / 2**30
