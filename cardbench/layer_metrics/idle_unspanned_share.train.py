"""The share of the traced window's device-idle time in which none of the
program's `wm.*` spans is open: the idle intervals (`trace.gaps`) less their
overlap with the union of the `wm.*` host spans, over the idle time, in
percent. What the spans cannot yet put down to a part of the program.
Nothing is read where the trace holds no device operation or no `wm.*`
span. Layer: the device."""

from cardbench.trace import gaps, union


def _overlap(a, b):
    """ns that two sorted lists of disjoint [start, end) intervals share."""
    shared, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        shared += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"].device_ops:
        return None
    spans = sorted((op for op in ctx["trace"].host_ops if op[0].startswith("wm.")),
                   key=lambda op: op[1])
    if not spans:
        return None
    idle = gaps(ctx["trace"])
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return 0.0
    return 100.0 * (total - _overlap(idle, union(spans))) / total
