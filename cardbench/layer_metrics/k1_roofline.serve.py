"""K1's share of its roofline: the least time its calls could take
(`roofline.k1_bound` over the forward's K1 call shapes, `flops.scan_calls`,
times the requests traced) over K1's device time by kernel name, in
percent. Layer: the kernels (`ops/scan_cuda.py`, `csrc/ss2d_scan.cu`).

K1 is the kernels named `chunk_scan` (its local pass and its replay) and
`chunk_prefix`. Where the trace holds fewer replays than K1's wrapper
counted launches, the profile dropped records and its time would read
low: nothing is returned."""

from cardbench.roofline import k1_bound


def _is_k1(name):
    return ("chunk_scan" in name and "ssd" not in name) or "chunk_prefix" in name


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"] or not ctx["k1_launches"]:
        return None
    trace = ctx["trace"]
    replays = sum(1 for n, _, _ in trace.device_ops
                  if "chunk_scan" in n and "ssd" not in n and "true" in n)
    if replays < ctx["k1_launches"]:
        return None
    seconds = trace.device_s(_is_k1)
    sb = ctx["stream_bytes"]
    least = sum(k1_bound(*c, x_bytes=sb, y_bytes=sb)[0] for c in ctx["k1_calls"])
    return 100.0 * least * ctx["requests"] / seconds
