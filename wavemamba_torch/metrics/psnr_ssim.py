"""MATLAB-parity PSNR / SSIM on the host in float64 numpy/scipy. The
counterpart of `wavemamba_tpu/metrics/psnr_ssim.py`, with the same
semantics. Inputs are HWC numpy arrays in [0, 255] uint8 (BGR, as from
cv2.imread) or [0, 1] float."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d

from wavemamba_torch.utils.color import to_y_channel


def _gaussian_kernel_1d(size=11, sigma=1.5):
    """cv2.getGaussianKernel parity."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _prep(img1, img2, crop_border, input_order):
    if img1.shape != img2.shape:
        raise ValueError(f"Image shapes are different: {img1.shape}, {img2.shape}.")
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order}")
    if input_order == "CHW":
        img1 = np.transpose(img1, (1, 2, 0))
        img2 = np.transpose(img2, (1, 2, 0))
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    return img1, img2


def calculate_psnr(img1, img2, crop_border=1, input_order="HWC", test_y_channel=True):
    """PSNR with auto max-value (1 vs 255) and optional Y-channel."""
    img1, img2 = _prep(img1, img2, crop_border, input_order)
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return 20.0 * np.log10(max_value / np.sqrt(mse))


def _ssim_map_mean(img1, img2, blur, max_value):
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = blur(img1**2) - mu1_sq
    s2 = blur(img2**2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def _separable_blur(axes):
    """Gaussian 11^k blur with replicate borders as 1-D passes over `axes`
    (exactly the dense correlation: per-axis replicate padding commutes)."""
    k = _gaussian_kernel_1d()

    def blur(x):
        for ax in axes:
            x = correlate1d(x, k, axis=ax, mode="nearest")
        return x

    return blur


def calculate_ssim(img1, img2, crop_border=1, input_order="HWC", test_y_channel=True):
    """SSIM: Y-channel 2-D Gaussian at 255 range, or colour 11^3 3-D Gaussian."""
    img1, img2 = _prep(img1, img2, crop_border, input_order)
    if test_y_channel:
        img1 = to_y_channel(img1).astype(np.float64)
        img2 = to_y_channel(img2).astype(np.float64)
        return _ssim_map_mean(img1[..., 0], img2[..., 0], _separable_blur((0, 1)), 255.0)
    max_value = 1.0 if img1.max() <= 1 else 255.0
    return _ssim_map_mean(img1, img2, _separable_blur((0, 1, 2)), max_value)
