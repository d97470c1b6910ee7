"""What the evaluation and measurement scripts share: the repository's root
(their default paths are relative to it), image reading, the model from a
`.pth`, one restored image, PSNR, device timing and the kernels' launch
counts."""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def repo_path(*parts):
    return os.path.join(REPO, *parts)


def read_rgb(path):
    """An image file -> float32 RGB HWC in [0, 1] (OpenCV reads BGR)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return np.ascontiguousarray(img[:, :, ::-1]).astype(np.float32) / 255.0


def write_rgb(img, path):
    """float RGB HWC in [0, 1] -> an 8-bit BGR image file."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, (np.clip(img, 0, 1)[:, :, ::-1] * 255).round().astype(np.uint8))


def psnr(a, b):
    """PSNR in dB of two arrays in [0, 1], the MSE in float64."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def load_model(path, cfg, device):
    """The WaveMamba of `cfg` with the `.pth` at `path` loaded strictly, on `device`."""
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.models import build_network

    return build_network({"type": "WaveMamba", **dataclasses.asdict(cfg)},
                         load_network(path, device=device), device=device)


def restore(model, img):
    """(H, W, 3) or (1, H, W, 3) float32 RGB -> the model's output, the same
    shape, numpy: reflect-padded to a multiple of 8, run, cropped back."""
    from wavemamba_torch.models.wavemamba import pad_to_multiple, wavemamba_apply

    batch = img if img.ndim == 4 else img[None]
    x, h, w = pad_to_multiple(np.ascontiguousarray(batch, np.float32), 8)
    dev = next(model.parameters()).device
    y = wavemamba_apply(model, torch.from_numpy(x).to(dev))[:, :h, :w].cpu().numpy()
    return y if img.ndim == 4 else y[0]


def set_parity_mode(device):
    """float32 parity on the card (no TF32), as the inference CLI runs."""
    if torch.device(device).type == "cuda":
        from wavemamba_torch.inference import set_parity_mode as parity

        parity()


def median_ms(fn, device, reps=3, iters=10):
    """Median over `reps` of the mean ms of `iters` calls of `fn`, after one
    warm-up call: by CUDA events on the card, by the host's clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def launches():
    """The launches of the kernels these scripts run, counted by their
    wrappers since the process started: K1 (`ss2d_scan_pair`) and K7
    (`fused_chain_band`)."""
    from wavemamba_torch.experimental.conv_fused import fused_chain_band
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    return {"K1": ss2d_scan_pair.launches, "K7": fused_chain_band.launches}


def print_launches():
    print("launches: " + json.dumps(launches()), flush=True)
