"""The reference training step: the batches, the loss, AdamW and its
learning rate, in plain PyTorch, for the options of a WaveMamba yml.

- Batches: the device-resident loader's documented draws, worked out again
  here. Epoch e takes the images in the order
  `RandomState(seed + e).permutation(n)`, and from
  `RandomState((seed + e) ^ 0x5EED)`, per batch, the crops' top rows, left
  columns and dihedral modes (1..7), each `randint` over the batch. Each
  pair is cropped at (top, left) to `gt_size` and turned by its mode as
  basicsr's `data_augmentation` does (np.rot90 k = mode // 2 times, then
  np.flipud when the mode is odd); uint8 to [0, 1].
- Loss: L1 plus `fft_weight` times the L1 between the stacked real and
  imaginary parts of the 2-D rFFT over the spatial axes (BasicSR's
  `L1Loss` and the upstream `FFTLoss`), NHWC.
- AdamW (Loshchilov and Hutter): decoupled weight decay, bias-corrected
  moments, eps added to the corrected root; the learning rate from
  `CosineAnnealingRestartCyclicLR`, step counted from 0.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch


def draws(n: int, batch: int, gt_size: int, height: int, width: int, seed: int, augs: bool):
    """Yields (indices, tops, lefts, modes) of each batch, epoch after epoch."""
    for epoch in itertools.count():
        order = np.random.RandomState(seed + epoch).permutation(n)
        rng = np.random.RandomState((seed + epoch) ^ 0x5EED)
        for b in range(n // batch):
            idx = order[b * batch:(b + 1) * batch]
            tops = rng.randint(0, height - gt_size + 1, size=batch)
            lefts = rng.randint(0, width - gt_size + 1, size=batch)
            modes = rng.randint(1, 8, size=batch) if augs else np.zeros(batch, np.int64)
            yield idx, tops, lefts, modes


def crop(images: np.ndarray, idx, tops, lefts, modes, size: int) -> np.ndarray:
    """(B, size, size, C) uint8: each image cropped, then turned by its mode."""
    out = []
    for i, t, l, m in zip(idx, tops, lefts, modes):
        img = images[i, t:t + size, l:l + size]
        k, flip = divmod(int(m), 2)
        img = np.rot90(img, k=k) if k else img
        out.append(np.flipud(img) if flip else img)
    return np.stack(out)


def loss(out, gt, pixel_weight: float, fft_weight: float):
    """out, gt: (B, H, W, C) in [0, 1]."""
    l1 = (out - gt).abs().mean()
    fo = torch.view_as_real(torch.fft.rfft2(out, dim=(1, 2)))
    fg = torch.view_as_real(torch.fft.rfft2(gt, dim=(1, 2)))
    return pixel_weight * l1 + fft_weight * (fo - fg).abs().mean()


def cyclic_cosine_lr(base: float, periods, restart_weights, eta_mins, step: int) -> float:
    """CosineAnnealingRestartCyclicLR; a step on a restart boundary still
    belongs to the period that ends there."""
    ends = list(itertools.accumulate(periods))
    i = min(sum(step > e for e in ends), len(ends) - 1)
    start = ends[i] - periods[i]
    eta = eta_mins[i]
    return eta + restart_weights[i] * 0.5 * (base - eta) * (1 + math.cos(math.pi * (step - start)
                                                                        / periods[i]))


class AdamW:
    """AdamW over named float32 parameters (a dict of leaf tensors)."""

    def __init__(self, params: dict, betas, eps=1e-8, weight_decay=0.0):
        self.params, self.betas, self.eps, self.wd = params, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * mhat / (vhat.sqrt() + self.eps))
