"""Device operations (kernels, copies, fills) per training step in the
traced window. Layer: host dispatch (`train/trainer.py`,
`models/wavemamba.py`)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"] or not ctx["trace"].device_ops:
        return None
    return len(ctx["trace"].device_ops) / ctx["steps"]
