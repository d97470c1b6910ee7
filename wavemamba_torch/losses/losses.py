"""Training losses: plain functions on NHWC tensors in about [0, 1], the JAX
package's layout. The counterpart of `wavemamba_tpu/losses/losses.py`
(the perceptual and style losses are `models/vgg.py:perceptual_loss`, as in
the JAX package).

Each pixel loss takes `(pred, target)` and returns a scalar tensor (or the
unreduced tensor for reduction='none'). The GAN penalties differentiate the
discriminator (or generator) with `torch.autograd.grad(...,
create_graph=True)`, so that the penalty itself trains; where the JAX
functions take a PRNG key, these take a `torch.Generator`.
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


# ---------------------------------------------------------------------------
# GAN losses.


def gan_loss(pred, target_is_real, gan_type="vanilla", real_label_val=1.0,
             fake_label_val=0.0, loss_weight=1.0, is_disc=False):
    """Generator / discriminator GAN loss: 'vanilla' (BCE with logits),
    'lsgan', 'wgan', 'wgan_softplus' or 'hinge'. `loss_weight` scales the
    generator's loss only, as in the reference."""
    if gan_type == "wgan":
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == "wgan_softplus":
        loss = F.softplus(-pred).mean() if target_is_real else F.softplus(pred).mean()
    elif gan_type == "hinge":
        if is_disc:
            p = -pred if target_is_real else pred
            loss = F.relu(1.0 + p).mean()
        else:
            loss = -pred.mean()
    else:
        target = torch.full_like(pred, real_label_val if target_is_real else fake_label_val)
        if gan_type == "vanilla":
            loss = (pred.clamp_min(0) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()
        elif gan_type == "lsgan":
            loss = ((pred - target) ** 2).mean()
        else:
            raise NotImplementedError(f"GAN type {gan_type} is not implemented.")
    return loss if is_disc else loss * loss_weight


def multi_scale_gan_loss(preds, target_is_real, **kw):
    """`gan_loss` averaged over a list of predictions (of a nested list, its
    last tensor)."""
    total = 0.0
    for p in preds:
        if isinstance(p, (list, tuple)):
            p = p[-1]
        total = total + gan_loss(p, target_is_real, **kw)
    return total / len(preds)


def _grad_of(fn, x):
    """d sum(fn(x)) / dx with the graph kept (a penalty that trains); x is
    `x` itself where it takes part in a graph, else a leaf copy of it."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    return torch.autograd.grad(fn(x).sum(), x, create_graph=True)[0]


def r1_penalty(disc_fn, real_img):
    """R1 gradient penalty: E[||grad D(x)||^2] over the batch."""
    grad = _grad_of(disc_fn, real_img)
    return (grad**2).sum() / real_img.shape[0]


def gradient_penalty_loss(disc_fn, real_data, fake_data, generator=None, weight=None):
    """WGAN-GP: E[(||grad D(x_hat)||_2 - 1)^2] at x_hat = alpha * real + (1 -
    alpha) * fake, alpha ~ U(0, 1) per image drawn from `generator`."""
    alpha = torch.rand((real_data.shape[0], 1, 1, 1), generator=generator,
                       device=generator.device if generator is not None else real_data.device)
    alpha = alpha.to(real_data)
    interp = (alpha * real_data + (1.0 - alpha) * fake_data).detach()
    grad = _grad_of(disc_fn, interp)
    if weight is not None:
        grad = grad * weight
    norm = torch.sqrt((grad**2).sum(dim=(1, 2, 3)) + 1e-12)
    gp = ((norm - 1.0) ** 2).mean()
    if weight is not None:
        gp = gp / weight.mean().clamp_min(1e-12)
    return gp


def g_path_regularize(gen_fn, latents, mean_path_length, generator=None, decay=0.01):
    """StyleGAN2's path-length regulariser. gen_fn: latents -> NHWC image;
    the noise N(0, 1) / sqrt(H * W) is drawn from `generator`. Returns
    (penalty, path_lengths, path_mean)."""
    if not latents.requires_grad:
        latents = latents.detach().requires_grad_(True)
    img = gen_fn(latents)
    noise = torch.randn(img.shape, generator=generator,
                        device=generator.device if generator is not None else img.device)
    noise = noise.to(img) / math.sqrt(img.shape[1] * img.shape[2])
    grad = torch.autograd.grad((img * noise).sum(), latents, create_graph=True)[0]
    path_lengths = torch.sqrt((grad**2).sum(-1).mean(-1) + 1e-12)
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = ((path_lengths - path_mean) ** 2).mean()
    return penalty, path_lengths, path_mean


def gan_feat_loss(pred_fake_feats, pred_real_feats, criterion="l1", loss_weight=1.0):
    """The discriminators' feature-matching loss (every feature but the final
    logits of each discriminator; no gradient to the real features)."""
    fn = {"l1": l1_loss, "l2": mse_loss, "charbonnier": charbonnier_loss}[criterion]
    num_d = len(pred_fake_feats)
    total = 0.0
    for fake_feats, real_feats in zip(pred_fake_feats, pred_real_feats):
        for f, r in zip(fake_feats[:-1], real_feats[:-1]):
            total = total + fn(f, r.detach()) / num_d
    return total * loss_weight


# ---------------------------------------------------------------------------
# Differentiable SSIM (UHDModel's training loss).


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
