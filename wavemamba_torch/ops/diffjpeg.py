"""Differentiable JPEG (`basicsr/utils/diffjpeg.py:26-515`) on the tensor's
device. The counterpart of `wavemamba_tpu/ops/diffjpeg.py`, NHWC as there.

Compress-decompress round trip with differentiable rounding
(round(x) + (x - round(x))^3), the standard luma / chroma quantization
tables scaled by JPEG quality, 2x chroma subsampling by mean pooling, and
the 8x8 DCT as products with its basis.

diff_jpeg(x, quality): x (B, H, W, 3) RGB in [0, 1], H and W multiples of 16.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

_Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.float32,
)
_C_TABLE = np.full((8, 8), 99, np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
)

# 8x8 DCT basis: dct[u, v, x, y]
_DCT = np.zeros((8, 8, 8, 8), np.float32)
for x, y, u, v in itertools.product(range(8), repeat=4):
    _DCT[u, v, x, y] = np.cos((2 * x + 1) * u * np.pi / 16) * np.cos(
        (2 * y + 1) * v * np.pi / 16
    )
_ALPHA = np.array([1.0 / np.sqrt(2)] + [1.0] * 7, np.float32)
_SCALE = np.outer(_ALPHA, _ALPHA) * 0.25
_RGB_TO_YCBCR = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]],
    np.float32)
_YCBCR_TO_RGB = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], np.float32)
_CHROMA_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)


def _quality_factor(quality):
    """The tables' scale, in float32 as the JAX package computes it."""
    q = torch.tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - q * 2.0) / 100.0


def _diff_round(x):
    r = torch.round(x)  # half to even, as jnp.round
    return r + (x - r) ** 3


def _blocks(x):  # (B, H, W) -> (B, nb, 8, 8)
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, -1, 8, 8)


def _unblocks(x, h, w):  # (B, nb, 8, 8) -> (B, H, W)
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h, w)


def _const(a, x):
    return torch.as_tensor(a, device=x.device)


def _encode(x, quality):
    """The DCT coefficients of every 8x8 block of Y and of the 2x subsampled
    Cb, Cr, each over its quantization table, and the tables."""
    b, h, w, _ = x.shape
    if h % 16 or w % 16:
        raise ValueError(f"H, W must be multiples of 16, got {h}x{w}")
    ycc = (x * 255.0) @ _const(_RGB_TO_YCBCR, x).T + _const(_CHROMA_SHIFT, x)

    def down(c):  # chroma 2x subsampling, mean pooling as the reference's avg_pool
        return c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    factor = _quality_factor(quality)
    yq, cq = (torch.clip(torch.round(torch.from_numpy(t) * factor), 1, 255).to(x.device)
              for t in (_Y_TABLE, _C_TABLE))
    dct, scale = _const(_DCT, x), _const(_SCALE, x)
    planes = (ycc[..., 0], down(ycc[..., 1]), down(ycc[..., 2]))
    tables = (yq, cq, cq)
    coefs = [torch.einsum("bnxy,uvxy->bnuv", _blocks(p) - 128.0, dct) * scale / t
             for p, t in zip(planes, tables)]
    return coefs, tables


def jpeg_coefficients(x, quality=80):
    """[Y, Cb, Cr]: each 8x8 block's DCT coefficients over the quantization
    table, before the rounding, (B, blocks, 8, 8); Cb and Cr after the 2x
    subsampling. Where two computations of one x round a coefficient to
    different integers, `diff_jpeg`'s outputs in that block differ by up to
    0.75 of the table's step."""
    return _encode(x, quality)[0]


def diff_jpeg(x, quality=80):
    """Differentiable JPEG round trip. x: (B, H, W, 3) RGB [0, 1] float32
    tensor; quality a number. Returns x's shape, clipped to [0, 1]."""
    b, h, w, _ = x.shape
    coefs, tables = _encode(x, quality)
    dct, scale = _const(_DCT, x), _const(_SCALE, x)

    def decode(c, table, hh, ww):  # the inverse DCT, alpha folded back symmetrically
        qd = _diff_round(c) * table
        return _unblocks(torch.einsum("bnuv,uvxy->bnxy", qd * scale * 4.0, dct) * 0.25 + 128.0,
                         hh, ww)

    def up(c):
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    y2 = decode(coefs[0], tables[0], h, w)
    cb2 = up(decode(coefs[1], tables[1], h // 2, w // 2))
    cr2 = up(decode(coefs[2], tables[2], h // 2, w // 2))
    out = (torch.stack([y2, cb2, cr2], dim=-1) - _const(_CHROMA_SHIFT, x)) @ _const(_YCBCR_TO_RGB, x).T
    return torch.clip(out / 255.0, 0.0, 1.0)
