"""Loss factory: YAML `{type: L1Loss, loss_weight: 1.0, ...}` -> a configured
callable. The counterpart of `wavemamba_tpu/losses/__init__.py`."""

import functools

from wavemamba_torch.losses.losses import (
    charbonnier_loss,
    fft_loss,
    g_path_regularize,
    gan_feat_loss,
    gan_loss,
    gradient_penalty_loss,
    l1_loss,
    mse_loss,
    multi_scale_gan_loss,
    psnr_loss,
    r1_penalty,
    ssim,
    ssim_loss,
    uhd_loss,
    weighted_tv_loss,
)

_LOSSES = {
    "L1Loss": l1_loss,
    "MSELoss": mse_loss,
    "CharbonnierLoss": charbonnier_loss,
    "PSNRLoss": lambda pred, target, loss_weight=1.0, reduction="mean", toY=False: psnr_loss(
        pred, target, loss_weight=loss_weight, to_y=toY
    ),
    "FFTLoss": fft_loss,
    "WeightedTVLoss": weighted_tv_loss,
    "SSIMLoss": ssim_loss,
    "GANLoss": gan_loss,
    "MultiScaleGANLoss": multi_scale_gan_loss,
    "GANFeatLoss": gan_feat_loss,
}


def build_loss(opt: dict):
    """opt: {'type': name, **kwargs} -> partial(loss_fn, **kwargs)."""
    opt = dict(opt)
    name = opt.pop("type")
    if name not in _LOSSES:
        raise KeyError(f"Unknown loss type {name!r}; known: {sorted(_LOSSES)}")
    return functools.partial(_LOSSES[name], **opt)


__all__ = ["build_loss", "l1_loss", "mse_loss", "charbonnier_loss", "psnr_loss", "fft_loss",
           "weighted_tv_loss", "ssim", "ssim_loss", "gan_loss", "multi_scale_gan_loss",
           "gan_feat_loss", "r1_penalty", "g_path_regularize", "gradient_penalty_loss",
           "uhd_loss"]
