"""The least time an ART attention call could take on one NVIDIA H100 SXM,
whatever implements it, with float32 accuracy.

`attention_bound` counts, for a call of B groups of N tokens, `heads`
heads of width hd (`flops_art.attention_calls`):

- bytes: q, k, v read once and the output written once, float32; each of
  the call's distinct (heads, N, N) masks (the bias with a pad class's
  keys) and its bias MLP table read once;
- products: q k^T and p v, 4 B heads N^2 hd FLOPs, at 495 / 3 TFLOP/s:
  three TF32 products give one accurate to float32 (the split of each
  operand into a high and a low TF32 part), the fastest float32-accurate
  route the card has, so no float32-accurate implementation reads over 100%;
- exponentials: one a score, B heads N^2, on the special-function units.

The slowest of the three is the bound.
"""

from __future__ import annotations

from cardbench.roofline import HBM_BYTES_S, SFU_OPS_S

TF32_OPS_S = 495e12  # dense TF32 tensor-core rate, NVIDIA H100 SXM data sheet
F32_ACCURATE_PRODUCT_OPS_S = TF32_OPS_S / 3


def attention_bound(B, heads, N, hd, masks=1, offsets=0):
    """(seconds, unit) of one call: unit 'hbm', 'tensor' or 'sfu'."""
    nbytes = 4 * (4 * B * heads * N * hd + masks * heads * N * N + offsets * heads)
    times = {"hbm": nbytes / HBM_BYTES_S,
             "tensor": 4 * B * heads * N * N * hd / F32_ACCURATE_PRODUCT_OPS_S,
             "sfu": B * heads * N * N / SFU_OPS_S}
    unit = max(times, key=times.get)
    return times[unit], unit
