"""Generic architecture helpers (`basicsr/archs/arch_util.py`) in torch idiom.
The counterpart of `wavemamba_tpu/ops/arch_util.py`, NCHW as the port's
model (the JAX package's are NHWC):

  * trunc_normal_         -> truncated normal init, in place, from a generator
  * default_init_weights  -> scaled kaiming-normal re-init of modules' weights
  * make_layer            -> nn.Sequential of identical blocks
  * ResidualBlockNoBN     -> conv-relu-conv residual block
  * Upsample              -> pixel-shuffle upsampler (2^n / 3x)
  * flow_warp             -> bilinear / nearest warp by optical flow

The modules' weights carry over from the JAX package's params (HWIO `w`,
`b`) by `conv.weight = w.transpose(3, 2, 0, 1)`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
    """Fill `tensor` with a normal(mean, std) truncated to [a, b], by the
    inverse CDF (timm / the reference's semantics), drawing from `generator`."""
    lo = math.erf((a - mean) / (std * math.sqrt(2.0)))
    hi = math.erf((b - mean) / (std * math.sqrt(2.0)))
    u = torch.empty(tensor.shape, dtype=torch.float32, device=tensor.device)
    u.uniform_(lo, hi, generator=generator)
    tensor.copy_(torch.clamp(mean + std * math.sqrt(2.0) * torch.erfinv(u), a, b))
    return tensor


@torch.no_grad()
def default_init_weights(module_list, scale=1.0, bias_fill=0.0, generator=None):
    """Kaiming-normal (fan in, gain sqrt(2)) weights times `scale` and
    `bias_fill` biases for every Conv2d and Linear in the modules."""
    if not isinstance(module_list, (list, tuple)):
        module_list = [module_list]
    for module in module_list:
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight, generator=generator)
                m.weight.mul_(scale)
                if m.bias is not None:
                    m.bias.fill_(bias_fill)


def make_layer(basic_block, num_basic_block, **kwarg):
    """`num_basic_block` blocks `basic_block(**kwarg)` in an nn.Sequential."""
    return nn.Sequential(*[basic_block(**kwarg) for _ in range(num_basic_block)])


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))) * res_scale, 3x3 convs without BatchNorm.
    Weights from `default_init_weights(scale=0.1)` unless `pytorch_init`."""

    def __init__(self, num_feat=64, res_scale=1.0, pytorch_init=False, generator=None):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1, bias=True)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1, bias=True)
        if not pytorch_init:
            default_init_weights([self.conv1, self.conv2], 0.1, generator=generator)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Sequential):
    """Conv + PixelShuffle upsampler for scale 2^n (n stages of x2) or 3."""

    def __init__(self, scale, num_feat):
        m = []
        if (scale & (scale - 1)) == 0:  # power of 2
            for _ in range(int(math.log2(scale))):
                m += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        elif scale == 3:
            m += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1), nn.PixelShuffle(3)]
        else:
            raise ValueError(f"scale {scale} is not supported. Supported scales: 2^n and 3.")
        super().__init__(*m)


def flow_warp(x, flow, interp_mode="bilinear"):
    """Warp x (N, C, H, W) by flow (N, H, W, 2), (dx, dy) pixel offsets:
    out(y, x) samples x at (y + dy, x + dx) with corners outside the image
    reading zero (grid_sample's zeros padding with align_corners=True),
    bilinear or nearest (rounding half to even). A gather on x's device."""
    if interp_mode not in ("bilinear", "nearest"):
        raise ValueError(f"interp_mode {interp_mode!r}: 'bilinear' or 'nearest'")
    n, c, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    sx = gx + flow[..., 0]
    sy = gy + flow[..., 1]
    flat = x.reshape(n, c, h * w)

    def gather(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
        g = torch.gather(flat, 2, idx.reshape(n, 1, h * w).expand(n, c, h * w)).reshape(n, c, h, w)
        return g * valid[:, None].to(x.dtype)

    if interp_mode == "nearest":
        return gather(torch.round(sy), torch.round(sx))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    return (gather(y0, x0) * ((1 - wx) * (1 - wy)) + gather(y0, x0 + 1) * (wx * (1 - wy))
            + gather(y0 + 1, x0) * ((1 - wx) * wy) + gather(y0 + 1, x0 + 1) * (wx * wy))
