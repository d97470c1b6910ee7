"""WaveMamba in plain float32 PyTorch: the benchmark's reference.

Wave-Mamba (Zou et al., ACM MM 2024, arXiv:2408.01276; upstream
github.com/AlexZou14/Wave-Mamba, `basicsr/archs/wavemamba_arch.py`): a
wavelet U-Net whose low-frequency branch runs SS2D state-space blocks
(LFSSBlock) and whose high-frequency branch runs channel-attention blocks
with channel matching (HFEBlock). Module and parameter names are the
upstream `.pth` keys, so `load_state_dict(strict=True)` takes the same state
dict as the program under test.

Everything is NCHW float32, stock `torch.nn.functional` operations and
`reference/scan.py`. Nothing here imports the program under test. Departures
from the upstream code, none of which changes the function computed:

- The selective scan is `reference/scan.py`, chunked two-pass evaluation of
  the same recurrence (upstream: the `mamba_ssm` CUDA kernel).
- The Haar DWT / IWT are written as slices of 2x2 blocks (upstream: the same
  sums through strided slicing in `dwt_init` / `iwt_init`).
- Channel matching takes squared distances as |x|^2 + |p|^2 - 2 x.p
  (upstream: `torch.cdist`), the same argmin up to rounding of near ties.
- `lower_precision(kind)` computes the reference one step below a
  configuration's precision, for the controls: 'tf32' (TF32 on in
  convolutions and matmuls), 'bf16' (bfloat16 autocast) or 'fp8' (every
  convolution's, linear layer's and matrix product's float operands rounded
  to float8 e4m3, saturating at its largest value, 448).
- Under autograd each LFSS and HFE block runs under
  `torch.utils.checkpoint` (as the upstream training does not), so that a
  step at batch 8 of 512x512 fits beside the program: recomputation gives
  the same values.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from cardbench.reference.scan import selective_scan


def _block(blk, *args):
    """A block, recomputed in the backward pass when a gradient is taken."""
    if torch.is_grad_enabled():
        return checkpoint(blk, *args, use_reentrant=False)
    return blk(*args)


def set_tf32(on: bool) -> None:
    """TF32 in cuDNN convolutions and cuBLAS matmuls: off is float32."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def _to_fp8(t):
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(t.dtype)
    return t


class _Fp8Operands(TorchFunctionMode):
    PRODUCTS = {F.conv2d, F.linear, torch.matmul, torch.bmm, torch.einsum,
                torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(_to_fp8(a) for a in args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def lower_precision(kind: str, device_type: str):
    """The reference computed one step below its float32 (the controls)."""
    if kind == "tf32":
        set_tf32(True)
        try:
            yield
        finally:
            set_tf32(False)
    elif kind == "bf16":
        with torch.autocast(device_type, dtype=torch.bfloat16):
            yield
    elif kind == "fp8":
        with _Fp8Operands():
            yield
    else:
        raise ValueError(f"unknown lower precision {kind!r}")


def layer_norm(x, weight, bias, eps, dim):
    mu = x.mean(dim, keepdim=True)
    var = (x - mu).square().mean(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x - mu) / torch.sqrt(var + eps) * weight.view(shape) + bias.view(shape)


class LayerNorm(nn.Module):
    def __init__(self, c, eps, dim=1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps, self.dim = eps, dim

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dim)


def dwt(x):
    """(B, C, H, W) -> LL, HL, LH, HH, each (B, C, H/2, W/2)."""
    x1 = x[:, :, 0::2, 0::2] / 2
    x2 = x[:, :, 1::2, 0::2] / 2
    x3 = x[:, :, 0::2, 1::2] / 2
    x4 = x[:, :, 1::2, 1::2] / 2
    return x1 + x2 + x3 + x4, -x1 - x2 + x3 + x4, -x1 + x2 - x3 + x4, x1 - x2 - x3 + x4


def iwt(x):
    """(B, 4C, h, w) = [LL | HL | LH | HH] -> (B, C, 2h, 2w)."""
    b, c4, h, w = x.shape
    x1, x2, x3, x4 = (t / 2 for t in x.chunk(4, dim=1))
    out = x.new_empty(b, c4 // 4, 2 * h, 2 * w)
    out[:, :, 0::2, 0::2] = x1 - x2 - x3 + x4
    out[:, :, 1::2, 0::2] = x1 - x2 + x3 - x4
    out[:, :, 0::2, 1::2] = x1 + x2 - x3 - x4
    out[:, :, 1::2, 1::2] = x1 + x2 + x3 + x4
    return out


class SS2D(nn.Module):
    """Four directional selective scans over the token grid (VMamba's SS2D)."""

    def __init__(self, c, d_state=16, d_conv=3, expand=2.0):
        super().__init__()
        d = int(expand * c)
        r = math.ceil(c / 16)
        self.in_proj = nn.Linear(c, 2 * d, bias=False)
        self.conv2d = nn.Conv2d(d, d, d_conv, padding=(d_conv - 1) // 2, groups=d)
        self.x_proj_weight = nn.Parameter(torch.zeros(4, r + 2 * d_state, d))
        self.dt_projs_weight = nn.Parameter(torch.zeros(4, d, r))
        self.dt_projs_bias = nn.Parameter(torch.zeros(4, d))
        self.A_logs = nn.Parameter(torch.zeros(4 * d, d_state))
        self.Ds = nn.Parameter(torch.ones(4 * d))
        self.out_norm = LayerNorm(d, eps=1e-5, dim=-1)
        self.out_proj = nn.Linear(d, c, bias=False)

    def forward(self, x):
        b, _, h, w = x.shape
        xz = self.in_proj(x.permute(0, 2, 3, 1))
        xx, z = xz.chunk(2, dim=-1)
        xx = F.silu(self.conv2d(xx.permute(0, 3, 1, 2)))  # (B, D, H, W)
        d, n = xx.shape[1], self.A_logs.shape[1]
        r = self.dt_projs_weight.shape[2]
        rows = xx.permute(0, 2, 3, 1).reshape(b, h * w, d)  # row-major tokens
        cols = xx.permute(0, 3, 2, 1).reshape(b, h * w, d)  # column-major tokens
        xs = torch.stack([rows, cols, rows.flip(1), cols.flip(1)], 1)  # (B, 4, L, D)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight)
        dts = torch.einsum("bklr,kdr->bkld", x_dbl[..., :r], self.dt_projs_weight)
        y = selective_scan(xs, dts, -torch.exp(self.A_logs).view(4, d, n),
                           x_dbl[..., r:r + n], x_dbl[..., r + n:], self.Ds.view(4, d),
                           self.dt_projs_bias)
        del xs, x_dbl, dts
        as_rows = lambda t: t.reshape(b, h, w, d)  # noqa: E731
        as_cols = lambda t: t.reshape(b, w, h, d).transpose(1, 2)  # noqa: E731
        y = as_rows(y[:, 0]) + as_cols(y[:, 1]) + as_rows(y[:, 2].flip(1)) \
            + as_cols(y[:, 3].flip(1))
        y = self.out_norm(y) * F.silu(z)
        return self.out_proj(y).permute(0, 3, 1, 2)


class FFN(nn.Module):
    def __init__(self, c, expand=2):
        super().__init__()
        dw = c * expand
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)

    def forward(self, x):
        y1, y2 = self.conv2(self.conv1(x)).chunk(2, dim=1)
        return self.conv3(F.gelu(y1) * y2)


class LFSSBlock(nn.Module):
    def __init__(self, c, d_state, expand):
        super().__init__()
        self.ln_1 = LayerNorm(c, eps=1e-6)
        self.self_attention = SS2D(c, d_state=d_state, expand=expand)
        self.skip_scale = nn.Parameter(torch.ones(c))
        self.ln_2 = LayerNorm(c, eps=1e-5)
        self.conv_blk = FFN(c)
        self.skip_scale2 = nn.Parameter(torch.ones(c))

    def forward(self, x):
        x = x * self.skip_scale.view(1, -1, 1, 1) + self.self_attention(self.ln_1(x))
        return x * self.skip_scale2.view(1, -1, 1, 1) + self.conv_blk(self.ln_2(x))


def matching(x, perc):
    """For each channel of x, the channel of `perc` nearest to it in L2 over
    the spatial map. The argmin carries no gradient; the gather does."""
    b, c, h, w = x.shape
    with torch.no_grad():
        xf, pf = x.reshape(b, c, h * w), perc.reshape(b, c, h * w)
        d2 = (xf * xf).sum(-1)[:, :, None] + (pf * pf).sum(-1)[:, None, :] \
            - 2.0 * torch.bmm(xf, pf.transpose(1, 2))
        idx = d2.argmin(-1)
    return torch.gather(perc.reshape(b, c, h * w), 1,
                        idx[:, :, None].expand(b, c, h * w)).view(b, c, h, w)


class PAConv(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.k2 = nn.Conv2d(nf, nf, 1)
        self.k3 = nn.Conv2d(nf, nf, 3, padding=1, bias=False)
        self.k4 = nn.Conv2d(nf, nf // 2, 3, padding=1, bias=False)

    def forward(self, x):
        return self.k4(self.k3(x) * torch.sigmoid(self.k2(x)))


class MatchingTransformation(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.paconv = PAConv(2 * c)

    def forward(self, x, perc):
        return self.paconv(torch.cat([x, matching(x, perc)], dim=1))


class CMTAttention(nn.Module):
    def __init__(self, c, num_heads=1):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(c, 3 * c, 1)
        self.qkv_dwconv = nn.Conv2d(3 * c, 3 * c, 3, padding=1, groups=3 * c)
        self.project_out = nn.Conv2d(c, c, 1)
        self.matching_transformation = MatchingTransformation(c)

    def forward(self, x, perc):
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        q = self.matching_transformation(q, perc)
        heads = lambda t: t.reshape(b, self.num_heads, c // self.num_heads, h * w)  # noqa: E731
        q, k, v = F.normalize(heads(q), dim=-1), F.normalize(heads(k), dim=-1), heads(v)
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature, dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class FeedForward(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.project_in = nn.Sequential(nn.Conv2d(c, c, 1), nn.Conv2d(c, c, 3, padding=1, groups=c))
        self.matching_transformation = MatchingTransformation(c)
        self.project_out = nn.Sequential(nn.Conv2d(c, c, 3, padding=1, groups=c), nn.GELU(),
                                         nn.Conv2d(c, c, 1))

    def forward(self, x, perc):
        return self.project_out(self.matching_transformation(self.project_in(x), perc))


class HFEBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm1 = LayerNorm(c, eps=1e-6)
        self.attn = CMTAttention(c)
        self.norm2 = LayerNorm(c, eps=1e-6)
        self.LayerNorm = LayerNorm(c, eps=1e-6)
        self.ffn = FeedForward(c)

    def forward(self, x, perc):
        perc = self.LayerNorm(perc)
        x = x + self.attn(self.norm1(x), perc)
        return x + self.ffn(self.norm2(x), perc)


class SKFF(nn.Module):
    def __init__(self, c, height=3, reduction=8):
        super().__init__()
        d = max(c // reduction, 4)
        self.conv_du = nn.Sequential(nn.Conv2d(c, d, 1, bias=False), nn.PReLU())
        self.fcs = nn.ModuleList(nn.Conv2d(d, c, 1, bias=False) for _ in range(height))

    def forward(self, feats):
        z = self.conv_du(sum(feats).mean(dim=(2, 3), keepdim=True))
        att = torch.softmax(torch.stack([fc(z) for fc in self.fcs], 0), dim=0)
        return sum(a * f for a, f in zip(att, feats))


class DownFRG(nn.Module):
    def __init__(self, c, n_l, n_h, d_state, expand):
        super().__init__()
        self.l_conv = nn.Conv2d(2 * c, c, 3, padding=1)
        self.l_blk = nn.ModuleList(LFSSBlock(c, d_state, expand) for _ in range(n_l))
        self.h_fusion = SKFF(c)
        self.h_blk = nn.ModuleList(HFEBlock(c) for _ in range(n_h))

    def forward(self, x, x_d):
        ll, hl, lh, hh = dwt(x)
        ll = self.l_conv(torch.cat([ll, x_d], dim=1))
        for blk in self.l_blk:
            ll = _block(blk, ll)
        xh = self.h_fusion([hl, lh, hh])
        for blk in self.h_blk:
            xh = _block(blk, xh, ll)
        return ll, xh


class UpFRG(nn.Module):
    def __init__(self, c, n_l, n_h, d_state, expand):
        super().__init__()
        self.l_blk = nn.ModuleList(LFSSBlock(c, d_state, expand) for _ in range(n_l))
        self.h_out_conv = nn.Conv2d(c, 3 * c, 3, padding=1)
        self.h_blk = nn.ModuleList(HFEBlock(c) for _ in range(n_h))

    def forward(self, x_l, x_h):
        for blk in self.l_blk:
            x_l = _block(blk, x_l)
        for blk in self.h_blk:
            x_h = _block(blk, x_h, x_l)
        return iwt(torch.cat([x_l, self.h_out_conv(x_h)], dim=1))


class UNet(nn.Module):
    def __init__(self, in_chn, wf, n_l_blocks, n_h_blocks, ffn_scale, d_state):
        super().__init__()
        c, ic = wf, in_chn
        self.ps_down1 = nn.Sequential(nn.PixelUnshuffle(2), nn.Conv2d(4 * ic, c, 1))
        self.ps_down2 = nn.Sequential(nn.PixelUnshuffle(4), nn.Conv2d(16 * ic, c, 1))
        self.ps_down3 = nn.Sequential(nn.PixelUnshuffle(8), nn.Conv2d(64 * ic, c, 1))
        self.conv_01 = nn.Conv2d(ic, c, 3, padding=1)
        groups = lambda kind: [kind(c, nl, nh, d_state, ffn_scale)  # noqa: E731
                               for nl, nh in zip(n_l_blocks, n_h_blocks)]
        self.down_group1, self.down_group2, self.down_group3 = groups(DownFRG)
        self.up_group1, self.up_group2, self.up_group3 = groups(UpFRG)
        self.last = nn.Conv2d(c, ic, 3, padding=1)

    def forward(self, x):
        x_l, xh1 = self.down_group1(self.conv_01(x), self.ps_down1(x))
        x_l, xh2 = self.down_group2(x_l, self.ps_down2(x))
        x_l, xh3 = self.down_group3(x_l, self.ps_down3(x))
        x_l = self.up_group3(x_l, xh3)
        x_l = self.up_group2(x_l, xh2)
        x_l = self.up_group1(x_l, xh1)
        return self.last(x_l) + x


class WaveMamba(nn.Module):
    """`network_g` of the upstream options: in_chn, wf, n_l_blocks,
    n_h_blocks, ffn_scale (SS2D's expansion), d_state."""

    def __init__(self, in_chn=3, wf=32, n_l_blocks=(1, 2, 4), n_h_blocks=(1, 1, 2),
                 ffn_scale=2.0, d_state=16):
        super().__init__()
        self.restoration_network = UNet(in_chn, wf, n_l_blocks, n_h_blocks, ffn_scale, d_state)

    def forward(self, x):
        """x: (B, in_chn, H, W), H and W multiples of 8."""
        return self.restoration_network(x)


def from_config(cfg: dict) -> WaveMamba:
    """The reference model of a configuration file's `network_g`."""
    g = cfg["network_g"]
    return WaveMamba(g["in_chn"], g["wf"], tuple(g["n_l_blocks"]), tuple(g["n_h_blocks"]),
                     g["ffn_scale"], g["d_state"])
