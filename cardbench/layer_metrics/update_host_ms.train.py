"""Host time a step in the program's span `wm.step.update`
(`train/trainer.py:make_train_step`: the clip, the LR write, AdamW's step
and the EMA): the span's summed duration over the traced window, over the
steps traced, in ms. Nothing is read where the trace holds no such span.
Layer: the trainer."""

SPAN = "wm.step.update"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    ns = [e - s for n, s, e in ctx["trace"].host_ops if n == SPAN]
    return 1e-6 * sum(ns) / ctx["steps"] if ns else None
