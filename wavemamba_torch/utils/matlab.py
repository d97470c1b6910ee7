"""MATLAB-parity bicubic imresize. The counterpart of
`wavemamba_tpu/utils/matlab.py` (`basicsr/utils/matlab_functions.py:86-178`),
the same numpy code: the BSRGAN degradations (`data/degradations.py`) resize
with it.

MATLAB's imresize uses a=-0.5 cubic with kernel-width scaling (antialiasing)
on downsample, and symmetric edge handling — none of which cv2/PIL reproduce.
Pure numpy, float64.
"""

from __future__ import annotations

import numpy as np


def _cubic(x):
    absx = np.abs(x)
    absx2 = absx**2
    absx3 = absx**3
    f1 = (1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
    f2 = (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2) * ((absx > 1) & (absx <= 2))
    return f1 + f2


def _weights_indices(in_length, out_length, scale, kernel_width, antialiasing):
    if (scale < 1) and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # (out, p), 0-based-ish
    dist = u[:, None] - (indices + 1)
    if (scale < 1) and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # trim zero columns
    nonzero = np.any(weights != 0, axis=0)
    first, last = np.argmax(nonzero), len(nonzero) - np.argmax(nonzero[::-1])
    weights = weights[:, first:last]
    indices = indices[:, first:last].astype(np.int64)
    # MATLAB 'symmetric' boundary (edge pixel duplicated): -1 -> 0, -2 -> 1;
    # n -> n-1, n+1 -> n-2.
    indices = np.where(indices < 0, -indices - 1, indices)
    indices = np.where(indices > in_length - 1, 2 * in_length - 1 - indices, indices)
    indices = np.clip(indices, 0, in_length - 1)
    return weights, indices


def imresize(img, scale, antialiasing=True):
    """img: HW or HWC numpy (any float/uint8; computed in float64).

    Matches MATLAB `imresize(img, scale, 'bicubic')`. uint8 inputs return
    float64 in the same 0-255 range (caller rounds if needed).
    """
    img = np.asarray(img, np.float64)
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    in_h, in_w, c = img.shape
    out_h = int(np.ceil(in_h * scale))
    out_w = int(np.ceil(in_w * scale))
    kernel_width = 4.0

    wh, ih = _weights_indices(in_h, out_h, scale, kernel_width, antialiasing)
    ww, iw = _weights_indices(in_w, out_w, scale, kernel_width, antialiasing)

    # rows: out[i, :, :] = sum_k wh[i,k] * img[ih[i,k], :, :]
    gathered = img[ih]  # (out_h, p, in_w, c)
    tmp = np.einsum("op,opwc->owc", wh, gathered)
    gathered_w = tmp[:, iw]  # (out_h, out_w, p, c)
    out = np.einsum("wp,owpc->owc", ww, gathered_w)
    if squeeze:
        out = out[:, :, 0]
    return out
