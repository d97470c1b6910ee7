"""Metric factory (psnr, ssim and lpips). The counterpart of
`wavemamba_tpu/metrics/__init__.py:build_metric`."""

from wavemamba_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim

# direction: True if higher is better.
METRIC_DIRECTION = {"psnr": True, "ssim": True, "lpips": False}


def build_metric(opt: dict, device="cuda"):
    """opt: {'type': 'psnr'|'ssim'|'lpips', ...kwargs} -> fn(img, img2) -> float.

    img/img2: HWC numpy, uint8 [0, 255] BGR or float [0, 1]. LPIPS needs
    `weights_path` (an AlexNet-LPIPS state dict, `metrics/lpips.py`) and runs
    on `device` (the card unless the caller asks for the CPU)."""
    opt = dict(opt)
    name = opt.pop("type").lower()
    opt.pop("better", None)
    if name == "psnr":
        return lambda a, b: calculate_psnr(a, b, **opt)
    if name == "ssim":
        return lambda a, b: calculate_ssim(a, b, **opt)
    if name == "lpips":
        import numpy as np
        import torch

        from wavemamba_torch.device import resolve_device
        from wavemamba_torch.metrics.lpips import load_lpips_params, lpips

        path = opt.pop("weights_path", None)
        if path is None:
            raise ValueError("lpips metric needs 'weights_path' (pretrained AlexNet+LPIPS "
                             "state dict); no network egress is assumed.")
        dev = resolve_device(device)
        net = load_lpips_params(path).to(dev).eval()

        def cvt(x):
            # uint8 BGR HWC -> RGB NHWC in [-1, 1], the reference's protocol
            x = np.asarray(x)
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0
            x = np.ascontiguousarray(x[..., ::-1], dtype=np.float32)
            return torch.from_numpy(x[None] * 2.0 - 1.0).to(dev)

        @torch.no_grad()
        def fn(a, b):
            return float(lpips(net, cvt(a), cvt(b))[0])

        return fn
    raise KeyError(f"Unknown metric type {name!r}")


__all__ = ["METRIC_DIRECTION", "build_metric", "calculate_psnr", "calculate_ssim"]
