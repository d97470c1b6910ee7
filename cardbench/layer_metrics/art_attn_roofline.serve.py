"""ART's attention calls' share of their roofline: the least time a
request's attention calls could take (`roofline_art.attention_bound` over
`flops_art.attention_calls` of the configuration and the bucket, times the
requests traced) over the device time of the kernels whose name holds
`fmha` or `attention`, in percent. Layer: the kernels (`models/art.py:
fused_attention`, torch's memory-efficient attention).

Where the trace holds fewer such kernels than the program counted calls
(`fused_attention.calls`), the profile dropped records and its time would
read low: nothing is returned; nothing either where the context carries no
count (a program without the counter)."""

from cardbench.roofline_art import attention_bound


def _is_attention(name):
    low = name.lower()
    return "fmha" in low or "attention" in low


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["requests"] or not ctx.get("attn_calls"):
        return None
    trace = ctx["trace"]
    if sum(1 for n, _, _ in trace.device_ops if _is_attention(n)) < ctx["attn_calls"]:
        return None
    seconds = trace.device_s(_is_attention)
    least = sum(attention_bound(*c)[0] for c in ctx["attn_shapes"])
    return 100.0 * least * ctx["requests"] / seconds
