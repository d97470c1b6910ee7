"""Training losses: plain functions on NHWC tensors in about [0, 1], the JAX
package's layout. The counterpart of `wavemamba_tpu/losses/losses.py`; the
GAN suite and the perceptual losses are not ported yet.

Each takes `(pred, target)` and returns a scalar tensor (or the unreduced
tensor for reduction='none').
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _reduce(x, weight, reduction):
    if weight is not None:
        x = x * weight
    if reduction == "none":
        return x
    if reduction == "sum":
        return x.sum()
    if reduction == "mean":
        if weight is None:
            return x.mean()
        # A weight that broadcasts over channels counts once per element it covers.
        return x.sum() / (weight.sum() * (x.numel() / weight.numel())).clamp_min(1e-12)
    raise ValueError(f"Unsupported reduction mode: {reduction}")


def l1_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    return loss_weight * _reduce((pred - target).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean"):
    return loss_weight * _reduce((pred - target) ** 2, weight, reduction)


def charbonnier_loss(pred, target, weight=None, loss_weight=1.0, reduction="mean", eps=1e-12):
    return loss_weight * _reduce(torch.sqrt((pred - target) ** 2 + eps), weight, reduction)


def psnr_loss(pred, target, loss_weight=1.0, to_y=False):
    """NAFNet PSNR loss: mean over the batch of 10/ln(10) * ln(mse + 1e-8);
    `to_y` first takes the BT.601 Y channel."""
    if to_y:
        coef = torch.tensor([65.481, 128.553, 24.966], dtype=pred.dtype, device=pred.device)
        pred = ((pred * coef).sum(-1, keepdim=True) + 16.0) / 255.0
        target = ((target * coef).sum(-1, keepdim=True) + 16.0) / 255.0
    scale = 10.0 / math.log(10.0)
    mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    return loss_weight * scale * torch.log(mse + 1e-8).mean()


def weighted_tv_loss(pred, weight=None, loss_weight=1.0, reduction="mean"):
    """Anisotropic TV: L1 of the differences between neighbours."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Unsupported reduction mode: {reduction}")
    yw = None if weight is None else weight[:, :-1, :, :]
    xw = None if weight is None else weight[:, :, :-1, :]
    y_diff = l1_loss(pred[:, :-1], pred[:, 1:], yw, loss_weight, reduction)
    x_diff = l1_loss(pred[:, :, :-1], pred[:, :, 1:], xw, loss_weight, reduction)
    return y_diff + x_diff


def fft_loss(pred, target, loss_weight=1.0, reduction="mean"):
    """L1 between the stacked real and imaginary parts of the 2-D rFFT over
    the spatial axes (1, 2)."""
    pf = torch.fft.rfft2(pred.float(), dim=(1, 2))
    tf = torch.fft.rfft2(target.float(), dim=(1, 2))
    return l1_loss(torch.view_as_real(pf), torch.view_as_real(tf), None, loss_weight, reduction)


def _gaussian_window(size=11, sigma=1.5):
    g = torch.exp(-((torch.arange(size, dtype=torch.float32) - size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, target, window_size=11, sigma=1.5):
    """Mean SSIM over an NHWC batch, differentiable: Gaussian window 11/1.5
    per channel, data range 1, C1 = 0.01^2, C2 = 0.03^2, zero 'same' padding."""
    c = pred.shape[-1]
    win = _gaussian_window(window_size, sigma).to(pred)
    kernel = win[None, None].expand(c, 1, window_size, window_size)

    def blur(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=window_size // 2, groups=c)

    mu1, mu2 = blur(pred), blur(target)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(pred * pred) - mu1_sq
    s2 = blur(target * target) - mu2_sq
    s12 = blur(pred * target) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean()


def ssim_loss(pred, target, loss_weight=1.0):
    return loss_weight * (1.0 - ssim(pred, target))


def uhd_loss(out, out8, gt, fft_weight=0.0):
    """UHDModel's composite loss: L1(out, gt) + 0.0004 * (1 - SSIM(out, gt)) +
    0.1 * L1(out8, gt at 1/8, bilinear with antialiasing) [+ FFT]. NHWC."""
    gt8 = F.interpolate(gt.permute(0, 3, 1, 2), size=(gt.shape[1] // 8, gt.shape[2] // 8),
                        mode="bilinear", antialias=True, align_corners=False).permute(0, 2, 3, 1)
    l_l1 = l1_loss(out, gt)
    l_l1_8 = l1_loss(out8, gt8)
    l_ssim = 1.0 - ssim(out, gt)
    total = l_l1 + 0.0004 * l_ssim + 0.1 * l_l1_8
    metrics = {"l_l1": l_l1, "l_ssim": l_ssim, "l_l1_8": l_l1_8}
    if fft_weight:
        l_fft = fft_loss(out, gt, loss_weight=fft_weight)
        total = total + l_fft
        metrics["l_freq"] = l_fft
    metrics["l_pix"] = total
    return total, metrics
