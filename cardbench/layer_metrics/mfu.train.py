"""Model FLOPs of the traced steps over the window's time times the
configuration's stated peak, in percent. A step counts three forwards'
FLOPs (`flops.py`, at the step's batch and crop): the forward, and the
backward's two products per forward one; the recompute of checkpointed
blocks is not model work and is not counted. Layer: the trainer
(`runner.py`, `train/trainer.py`, `losses/`)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"] or not ctx["trace"].device_ops:
        return None
    done = ctx["flops_per_step"] * ctx["steps"]
    return 100.0 * done / (ctx["trace"].window_s * ctx["peak_flops"])
