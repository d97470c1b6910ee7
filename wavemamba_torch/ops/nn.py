"""Neural-net primitives that stock PyTorch does not give in the form the
model needs. The counterpart of `wavemamba_tpu/ops/nn.py`.

The port keeps the reference's NCHW layout inside the model, so most of the
JAX module maps onto stock modules and functions, each held against its JAX
counterpart by `tests/test_torch_ops.py`:

    conv2d (HWIO, NHWC)     -> nn.Conv2d (OIHW, NCHW; groups, padding), and
                               off float32 a 1x1 as a token matmul (`Conv2d`)
    linear ((in, out))      -> nn.Linear ((out, in))
    gelu (exact erf), silu  -> F.gelu, F.silu
    prelu (one slope)       -> nn.PReLU()
    pixel_(un)shuffle       -> nn.PixelUnshuffle, F.pixel_shuffle

What is left is the LayerNorm with float32 statistics over an arbitrary axis
(the model normalises over the last axis in SS2D and over channels, axis 1,
everywhere else), the L2 normalisation of the channel attention, and the
initialisers: the JAX package's `init_*` return new arrays from a key, these
fill a module's parameters in place from a `torch.Generator`.

The bf16 policy of the JAX module: parameters stay float32 and every conv,
linear and PReLU casts its weight and bias to the activation's dtype
(`.astype(x.dtype)` there; `Conv2d`, `Linear` and `PReLU` here, stock
modules whose forward casts), and LayerNorm takes float32 statistics and
returns the input's dtype. The casts are written out, not left to
`torch.autocast`, whose op lists run LayerNorm and softmax in float32 and
hand float32 on, where the JAX model stays in bf16. On float32 activations
the casts are no-ops and the modules compute what the stock ones do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def network_forward(model, x):
    """x: (B, H, W, C) NHWC -> the model's output, float32 NHWC, for a model
    of any arch: every arch's module takes and gives NCHW, and the JAX
    package's apply functions take and give NHWC. Differentiable."""
    return model(x.permute(0, 3, 1, 2).float()).permute(0, 2, 3, 1)


@torch.no_grad()
def network_apply(model, x):
    """`network_forward` without a gradient."""
    return network_forward(model, x)


def layer_norm(x, weight, bias, eps=1e-5, dim=-1):
    """LayerNorm over axis `dim`, float32 statistics (biased variance)."""
    xf = x.float()
    mu = xf.mean(dim, keepdim=True)
    var = (xf - mu).square().mean(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float().view(shape) + bias.float().view(shape)).to(x.dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose weight and bias take the input's dtype.

    The JAX module's lowering rule: on an input that is not float32, a 1x1
    conv with stride 1, one group and no padding is a token matmul, the
    weight (Cout, Cin) times x (B, Cin, H*W) in x's dtype, then the bias added
    in that dtype, unless `as_conv` opts the call site out (the JAX config's
    `conv1x1_as_conv` regions). float32 keeps the conv, as there."""

    def __init__(self, *args, as_conv=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.as_conv = as_conv

    def lowers_to_matmul(self, x) -> bool:
        return (x.dtype != torch.float32 and not self.as_conv and self.kernel_size == (1, 1)
                and self.stride == (1, 1) and self.groups == 1
                and self.padding in ((0, 0), "valid", "same"))

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.lowers_to_matmul(x):
            b, _, h, w = x.shape
            y = torch.matmul(self.weight.to(x.dtype).view(self.out_channels, -1), x.flatten(2))
            if bias is not None:
                y = y + bias.view(1, -1, 1)
            return y.view(b, -1, h, w)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """`nn.Linear` whose weight and bias take the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class PReLU(nn.PReLU):
    """`nn.PReLU` whose slope takes the input's dtype."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class LayerNorm(nn.Module):
    """Parameters `weight`/`bias` (the `.pth` names) over axis `dim`."""

    def __init__(self, c, eps, dim=1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps
        self.dim = dim

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dim)


def l2_normalize(x, dim=-1, eps=1e-12):
    """torch F.normalize(p=2): x / max(||x||_2, eps)."""
    return F.normalize(x, p=2.0, dim=dim, eps=eps)


def _fan_in_uniform(t, fan_in, generator):
    """Fill `t` with U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn from `generator`
    (on the generator's device, then copied to the tensor's)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        t.copy_(torch.empty(t.shape, device=generator.device).uniform_(
            -bound, bound, generator=generator))


def init_conv2d(m: nn.Conv2d, generator):
    """torch's nn.Conv2d default (kaiming_uniform a=sqrt(5) == U(+-1/sqrt(fan_in)))
    for the weight and the bias."""
    fan_in = (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
    _fan_in_uniform(m.weight, fan_in, generator)
    if m.bias is not None:
        _fan_in_uniform(m.bias, fan_in, generator)


def init_linear(m: nn.Linear, generator):
    _fan_in_uniform(m.weight, m.in_features, generator)
    if m.bias is not None:
        _fan_in_uniform(m.bias, m.in_features, generator)


def init_layer_norm(m: LayerNorm):
    with torch.no_grad():
        m.weight.fill_(1.0)
        m.bias.fill_(0.0)
