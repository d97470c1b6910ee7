"""Image filtering helpers: batched 2-D filtering on the tensor's device and
USM (unsharp-mask) sharpening on the host. The counterpart of
`wavemamba_tpu/utils/img_process_util.py` (`basicsr/utils/img_process_util.py:7-83`),
NHWC at the interface as there."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def filter2d(img, kernel):
    """Per-channel 2-D filter, a depthwise cross-correlation (no kernel flip)
    with zero padding of k // 2 on each side, on `img`'s device.

    img: (B, H, W, C) tensor; kernel: (k, k), shared by every sample, or
    (B, k, k), one a sample. Returns (B, H', W', C) in img's dtype (H' = H
    for odd k)."""
    img = torch.as_tensor(img)
    kernel = torch.as_tensor(kernel, device=img.device).to(img.dtype)
    b, h, w, c = img.shape
    k = kernel.shape[-1]
    x = img.permute(0, 3, 1, 2)  # NCHW
    if kernel.dim() == 2:
        weight = kernel.expand(c, 1, k, k)
        return F.conv2d(x, weight, padding=k // 2, groups=c).permute(0, 2, 3, 1)
    # Per-sample kernels: the batch folds into the channels, one group each.
    weight = kernel[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    y = F.conv2d(x.reshape(1, b * c, h, w), weight, padding=k // 2, groups=b * c)
    return y.reshape(b, c, y.shape[-2], y.shape[-1]).permute(0, 2, 3, 1)


def usm_sharp(img, weight=0.5, radius=50, threshold=10):
    """Unsharp masking with a soft edge mask (reference semantics).

    img: HWC float [0, 1] numpy. Host-side (OpenCV's Gaussian blur)."""
    import cv2

    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img
