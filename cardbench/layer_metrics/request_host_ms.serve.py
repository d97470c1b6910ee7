"""Host time a request: the mean request wall time (the benchmark's own
span around each request) minus the device's busy time per request, over
the traced window. Layer: the request path (`inference.enhance`,
`utils/img_util.py`, `models/buckets.py`)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"]:
        return None
    busy = ctx["trace"].busy_s()
    if busy <= 0:
        return None
    mean_wall = sum(ctx["request_s"]) / len(ctx["request_s"])
    return (mean_wall - busy / ctx["requests"]) * 1e3
