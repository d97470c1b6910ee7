"""Bucket ladder for mixed-size folders, and the port's one bottom/right
reflect pad, which every front door takes: the CLI (`inference.enhance`),
validation (`runner.RestorationModel`) and the `.wmt` route (`deploy`).

The counterpart of `wavemamba_tpu/models/buckets.py`. An image is padded up
to the smallest bucket already seen that fits it with at most `max_waste`
area overhead; otherwise its own 128-multiple becomes a new bucket. SS2D's
scan is global, so the pad perturbs outputs near the borders at the 1e-3
scale; `--no_bucket` pads each image to its own 128-multiple instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class BucketLadder:
    def __init__(self, multiple=128, max_waste=1.35):
        self.multiple = multiple
        self.max_waste = max_waste
        self.buckets: list[tuple[int, int]] = []

    def shape_for(self, h, w):
        m = self.multiple
        H, W = -(-h // m) * m, -(-w // m) * m
        best = None
        for bh, bw in self.buckets:
            if bh >= H and bw >= W and (best is None or bh * bw < best[0] * best[1]):
                best = (bh, bw)
        if best is not None and best[0] * best[1] <= self.max_waste * H * W:
            return best
        self.buckets.append((H, W))
        return (H, W)


def pad_to_shape(x, H, W):
    """Reflect-pad (B, h, w, C) bottom/right to exactly (H, W), re-reflecting
    a pad wider than the image as numpy does. An array is padded by
    `np.pad`; a tensor by `F.pad` on its device where every pad is narrower
    than its extent (`F.pad` raises otherwise), else through numpy and back
    to its device. x itself where (H, W) is its size."""
    _, h, w, _ = x.shape
    ph, pw = H - h, W - w
    if ph == 0 and pw == 0:
        return x
    if isinstance(x, torch.Tensor):
        if ph < h and pw < w:
            return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
        return torch.from_numpy(pad_to_shape(x.cpu().numpy(), H, W)).to(x.device)
    return np.pad(np.asarray(x), ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
