"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit) and the least time a scan kernel call could
take on it.

`k1_bound` and `k2_bound` count the operations and bytes that K1 (the fused
SS2D projection + scan) and K2 (its backward) need for a call of shape
(B, L, D, N, R), whatever implements them: each input byte read once, each
output byte written once, each operation computed once. Their bodies are
those of the repository's measurement script at the time the benchmark was
written, kept here so that the yardstick cannot move with the program.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12  # FP32 outside the tensor cores (the FMA pipe)
SFU_OPS_S = F32_OPS_S / 16  # special-function units: ex2, rcp, rsqrt
TENSOR_BF16_OPS_S = 989e12


def _bound(nbytes, fma_ops, sfu_ops, tensor_ops=0):
    """(seconds, "bytes" or "operations", unit) of the slowest of the units."""
    times = {"hbm": nbytes / HBM_BYTES_S, "fma": fma_ops / F32_OPS_S,
             "sfu": sfu_ops / SFU_OPS_S, "tensor": tensor_ops / TENSOR_BF16_OPS_S}
    unit = max(times, key=times.get)
    return times[unit], ("bytes" if unit == "hbm" else "operations"), unit


def k1_bound(B, L, D, N, R, x_bytes=4, y_bytes=None):
    """Least seconds for one K1 call.

    Bytes: x read once (`x_bytes` a value: 2 in bf16), y written once
    (`y_bytes`, x's by default), the weights read once. Per (token,
    direction), each computed once: on the FMA pipe, an FMA counted as two,
    the projection 2D(R+2N), dt 2RD, log1p of the softplus D, the recurrence
    6 per (n, d) (da*A, the FMA of h, du*B, the FMA of C.h), du D and the
    output FMA 2D; on the SFU, one exp per (n, d) and one per d for the
    softplus."""
    weights = 2 * D * (R + 2 * N) + 2 * R * D + 2 * D + 2 * N * D + 2 * D
    nbytes = x_bytes * B * L * D + (y_bytes or x_bytes) * 2 * B * L * D + 4 * weights
    fma_ops = 2 * B * L * (2 * D * (R + 2 * N) + 2 * R * D + D + 6 * N * D + D + 2 * D)
    sfu_ops = 2 * B * L * (N * D + D)
    return _bound(nbytes, fma_ops, sfu_ops)


def k2_bound(B, L, D, N, R, T=64, stream_bytes=4, dy_bytes=None):
    """Least seconds for one K2 call; as `k1_bound`.

    Bytes: x and dy read once, dx written once (`stream_bytes` each, dy
    `dy_bytes` where it differs), the chunk-entry states and chunk decays
    read once, the weights read and their gradients written. Per (token,
    direction), each computed once: on the FMA pipe, the projection 2DJ
    (J = R+2N) and dt 2RD; per (n, d) the state's recompute 4 and the adjoint
    13; the sums over channels for dB and dC 3ND; the projection backward
    2RD + 2DJ, the weight sums 2DJ + 2RD, and some 10 D for the softplus, the
    sigmoid's divide, dz, du and the small sums. On the SFU one exp per
    (n, d) and three per d."""
    J = R + 2 * N
    nc = -(-L // T)
    weights = 2 * D * J + 2 * R * D + 2 * D + 2 * N * D + 2 * D
    nbytes = B * L * D * (2 * stream_bytes + 2 * (dy_bytes or stream_bytes)) \
        + 4 * (B * 2 * nc * (N * D + D) + 2 * weights)
    fma_ops = 2 * B * L * (3 * 2 * D * J + 3 * 2 * R * D + (4 + 13 + 3) * N * D + 10 * D)
    sfu_ops = 2 * B * L * (N * D + 3 * D)
    return _bound(nbytes, fma_ops, sfu_ops)
