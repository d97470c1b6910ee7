"""Host time a step spends in the loader's `next()` (the benchmark's own
span), the mean over the traced steps. Layer: data
(`data/device_cache.py`)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["data_wait_s"]:
        return None
    return 1e3 * sum(ctx["data_wait_s"]) / len(ctx["data_wait_s"])
