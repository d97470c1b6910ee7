"""Haar DWT / inverse DWT as reshape/slice arithmetic, NCHW.

The counterpart of `wavemamba_tpu/ops/haar.py` (the float32 slicing forms).
Each 2x2 block ``[[p00, p01], [p10, p11]]`` (rows, cols) gives, with
``xi = p / 2``:

    LL =  x1 + x2 + x3 + x4
    HL = -x1 - x2 + x3 + x4
    LH = -x1 + x2 - x3 + x4
    HH =  x1 - x2 - x3 + x4

where x1 = p[even row, even col], x2 = p[odd row, even col],
x3 = p[even row, odd col], x4 = p[odd row, odd col].
"""

from __future__ import annotations

import torch


def dwt2(x):
    """x: (B, C, H, W), even H and W -> (LL, HL, LH, HH), each (B, C, H/2, W/2)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2) * 0.5  # axis 3: row parity, 5: col parity
    x1 = x[:, :, :, 0, :, 0]
    x2 = x[:, :, :, 1, :, 0]
    x3 = x[:, :, :, 0, :, 1]
    x4 = x[:, :, :, 1, :, 1]
    return x1 + x2 + x3 + x4, -x1 - x2 + x3 + x4, -x1 + x2 - x3 + x4, x1 - x2 - x3 + x4


def iwt2(ll, hl, lh, hh):
    """Inverse Haar DWT: four (B, C, h, w) subbands -> (B, C, 2h, 2w)."""
    b, c, h, w = ll.shape
    x1, x2, x3, x4 = ll * 0.5, hl * 0.5, lh * 0.5, hh * 0.5
    p00 = x1 - x2 - x3 + x4
    p10 = x1 - x2 + x3 - x4
    p01 = x1 + x2 - x3 - x4
    p11 = x1 + x2 + x3 + x4
    rows_even = torch.stack([p00, p01], -1)  # (B, C, h, w, 2)
    rows_odd = torch.stack([p10, p11], -1)
    return torch.stack([rows_even, rows_odd], 3).reshape(b, c, 2 * h, 2 * w)


def iwt2_cat(x):
    """Inverse DWT of channel-concatenated subbands [LL|HL|LH|HH]:
    (B, 4C, h, w) -> (B, C, 2h, 2w)."""
    return iwt2(*x.chunk(4, dim=1))
