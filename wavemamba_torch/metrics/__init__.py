"""Metric factory (psnr and ssim). The counterpart of
`wavemamba_tpu/metrics/__init__.py:build_metric`."""

from wavemamba_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim

# direction: True if higher is better.
METRIC_DIRECTION = {"psnr": True, "ssim": True, "lpips": False}


def build_metric(opt: dict):
    """opt: {'type': 'psnr'|'ssim', ...kwargs} -> fn(img, img2) -> float.

    img/img2: HWC numpy, uint8 [0, 255] BGR or float [0, 1]."""
    opt = dict(opt)
    name = opt.pop("type").lower()
    opt.pop("better", None)
    if name == "psnr":
        return lambda a, b: calculate_psnr(a, b, **opt)
    if name == "ssim":
        return lambda a, b: calculate_ssim(a, b, **opt)
    if name == "lpips":
        raise NotImplementedError("lpips is not ported yet (ROADMAP queue 1, item 11)")
    raise KeyError(f"Unknown metric type {name!r}")


__all__ = ["METRIC_DIRECTION", "build_metric", "calculate_psnr", "calculate_ssim"]
