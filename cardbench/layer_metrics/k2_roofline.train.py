"""K2's share of its roofline: the least time its calls could take
(`roofline.k2_bound` over the step's K2 call shapes, `flops.scan_calls` at
the step's batch and crop, times the steps traced) over K2's device time by
kernel name, in percent. Layer: the kernels (`ops/scan_cuda.py`,
`csrc/ss2d_scan_bwd.cu`).

K2 is the kernels named `bwd_local`, `bwd_prefix`, `bwd_main` and
`bwd_reduce`, one `bwd_main` a call. Where the trace holds fewer `bwd_main`
than K2's wrapper counted launches, the profile dropped records and its
time would read low: nothing is returned."""

from cardbench.roofline import k2_bound

NAMES = ("bwd_local", "bwd_prefix", "bwd_main", "bwd_reduce")


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"] or not ctx["k2_launches"]:
        return None
    trace = ctx["trace"]
    mains = sum(1 for n, _, _ in trace.device_ops if "bwd_main" in n)
    if mains < ctx["k2_launches"]:
        return None
    seconds = trace.device_s(lambda n: any(k in n for k in NAMES))
    sb = ctx["stream_bytes"]
    least = sum(k2_bound(*c, stream_bytes=sb)[0] for c in ctx["k2_calls"])
    return 100.0 * least * ctx["steps"] / seconds
