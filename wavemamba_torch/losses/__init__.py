"""Loss factory: YAML `{type: L1Loss, loss_weight: 1.0, ...}` -> a configured
callable. The counterpart of `wavemamba_tpu/losses/__init__.py`, without the
GAN and perceptual losses (not ported yet)."""

import functools

from wavemamba_torch.losses.losses import (
    charbonnier_loss,
    fft_loss,
    l1_loss,
    mse_loss,
    psnr_loss,
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
}


def build_loss(opt: dict):
    """opt: {'type': name, **kwargs} -> partial(loss_fn, **kwargs)."""
    opt = dict(opt)
    name = opt.pop("type")
    if name not in _LOSSES:
        raise KeyError(f"Unknown loss type {name!r}; known: {sorted(_LOSSES)}")
    return functools.partial(_LOSSES[name], **opt)


__all__ = ["build_loss", "l1_loss", "mse_loss", "charbonnier_loss", "psnr_loss", "fft_loss",
           "weighted_tv_loss", "ssim", "ssim_loss", "uhd_loss"]
