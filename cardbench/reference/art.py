"""ART in plain float32 PyTorch: the benchmark's reference for `art-*`
configurations.

ART (Zhang et al., "Accurate Image Restoration with Attention Retractable
Transformer", ICLR 2023, arXiv:2210.01427), in the variant that upstream
Wave-Mamba (github.com/AlexZou14/Wave-Mamba) registers as `ART` in
`basicsr/archs/art_arch.py`, with that wrapper's defaults: a 3x3 conv stem
to dim / u channels and a pixel unshuffle by u (so u * dim channels on an
(H/u, W/u) token grid), blocks, a global residual, a 3x3 conv to 3 u^2
channels and a pixel shuffle. Each block:

- x' = LayerNorm(x);
- dense attention over G x G windows of x' (G = min(window, h, w)) and
  sparse attention over the I x I sets of tokens I apart (each set a gh x gw
  grid), both with the same qkv, proj and position-bias weights: q scaled
  by hd^-0.5, scores q k^T plus a per-head bias B[dy, dx] that an MLP
  (Linear 2 -> d/4, then three stages LayerNorm, ReLU, Linear; d/4 = dim / 4
  of the block's width over 4) gives for every offset (dy, dx) in the grid,
  softmax, times v, heads joined, proj. The grid is zero-padded bottom and
  right to a multiple of G or I, and a pad token takes -1e6 as a key;
- the two results, cropped, concatenated on channels and fused by a 1x1 conv;
- x + the fusion, then + Linear(GELU(Linear(LayerNorm(.)))), exact GELU,
  hidden width mlp_ratio x channels.

Parameter names are the upstream `.pth` keys (`restoration_network.feats.N
.attn.pos.pos1.2.weight`, ...), so `load_state_dict(strict=True)` takes the
program's state dict. Nothing here imports the program under test.

Departures from upstream, none of which changes the function computed:

- Both attentions are computed a chunk of groups at a time, the scores of at
  most `CHUNK_VALUES` float32 values at once, so that a 2176x3840 frame fits
  (one sparse attention there would hold 256 x 6 x 2040 x 2040 values,
  25.6 GB).
- The fusion conv's NCHW output is read as (B, H*W, C) tokens without a
  permute, which mixes channels across tokens: upstream does this with a
  `.view` of the contiguous NCHW tensor, and trained checkpoints depend on
  it; here it is a `reshape`, the same values.
- The pad marks are added to the scores after the bias, for every group, as
  an additive (groups, N) row over the keys; upstream builds the same values
  as a (groups, N, N) mask.
- `set_tf32` and `lower_precision` are the WaveMamba reference's: the control
  runs this reference one step below float32 with TF32 on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.wavemamba import layer_norm, lower_precision, set_tf32  # noqa: F401

NEG_INF = -1000000.0
CHUNK_VALUES = 1 << 28  # scores held at once: 1 GiB of float32


class LayerNorm(nn.Module):
    """Over the last axis, eps 1e-5."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, 1e-5, -1)


class PosBias(nn.Module):
    """The dynamic position bias: an offset (dy, dx) -> a bias per head."""

    def __init__(self, dim, heads):
        super().__init__()
        d = dim // 4

        def stage(cout):
            return nn.Sequential(LayerNorm(d), nn.ReLU(), nn.Linear(d, cout))

        self.pos_proj = nn.Linear(2, d)
        self.pos1, self.pos2, self.pos3 = stage(d), stage(d), stage(heads)

    def forward(self, offsets):
        return self.pos3(self.pos2(self.pos1(self.pos_proj(offsets))))


def relative_bias(pos: PosBias, gh: int, gw: int, device) -> torch.Tensor:
    """(heads, N, N) for a gh x gw grid of N tokens: the bias of token i
    against token j is the MLP's output at their offset (y_i - y_j,
    x_i - x_j), the offsets listed row-major from (1 - gh, 1 - gw)."""
    dy = torch.arange(1 - gh, gh, device=device)
    dx = torch.arange(1 - gw, gw, device=device)
    offsets = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), -1).reshape(-1, 2)
    table = pos(offsets.float())  # ((2gh-1)(2gw-1), heads)
    ys = torch.arange(gh, device=device).repeat_interleave(gw)
    xs = torch.arange(gw, device=device).repeat(gh)
    index = (ys[:, None] - ys[None, :] + gh - 1) * (2 * gw - 1) + (xs[:, None] - xs[None, :] + gw - 1)
    return table[index].permute(2, 0, 1)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.pos = PosBias(dim // 4, heads)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, gh, gw, key_mask=None):
        """x: (groups, N, C) tokens of gh x gw grids; key_mask: (groups, N),
        added to every score against that key, or None."""
        g, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(g, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q = q * hd**-0.5
        bias = relative_bias(self.pos, gh, gw, x.device)
        out = torch.empty_like(q)
        step = max(1, CHUNK_VALUES // (self.heads * n * n))
        for s in range(0, g, step):
            scores = q[s:s + step] @ k[s:s + step].transpose(-2, -1) + bias
            if key_mask is not None:
                scores = scores + key_mask[s:s + step, None, None, :]
            out[s:s + step] = scores.softmax(-1) @ v[s:s + step]
        return self.proj(out.transpose(1, 2).reshape(g, n, c))


def windows(t, s):
    """(B, H, W, C), H and W multiples of s -> (B x H/s x W/s, s*s, C)."""
    b, h, w, c = t.shape
    return t.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, s * s, c)


def from_windows(t, b, h, w, s):
    c = t.shape[-1]
    return t.reshape(b, h // s, w // s, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def intervals(t, i):
    """(B, H, W, C), H and W multiples of i -> (B x i x i, H/i * W/i, C): the
    tokens i apart from each offset (oy, ox) in an i x i tile."""
    b, h, w, c = t.shape
    return t.reshape(b, h // i, i, w // i, i, c).permute(0, 2, 4, 1, 3, 5).reshape(
        -1, (h // i) * (w // i), c)


def from_intervals(t, b, h, w, i):
    c = t.shape[-1]
    return t.reshape(b, i, i, h // i, w // i, c).permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)


class Block(nn.Module):
    def __init__(self, c, heads, window, interval, mlp_ratio):
        super().__init__()
        self.window, self.interval = window, interval
        self.norm1 = LayerNorm(c)
        self.attn = Attention(c, heads)
        self.fusion = nn.Conv2d(2 * c, c, 1)
        self.norm2 = LayerNorm(c)
        hidden = int(c * mlp_ratio)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = nn.Linear(c, hidden), nn.Linear(hidden, c)

    def _attend(self, y, size, group, ungroup):
        """Attention over the groups that `group` makes of y, zero-padded to
        a multiple of `size`, cropped back."""
        b, h, w, c = y.shape
        hp, wp = -(-h // size) * size, -(-w // size) * size
        padded = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        marks = torch.zeros(1, hp, wp, 1, device=y.device)
        marks[:, h:] = NEG_INF
        marks[:, :, w:] = NEG_INF
        key_mask = group(marks, size)[..., 0].repeat(b, 1) if (hp, wp) != (h, w) else None
        grid = (size, size) if group is windows else (hp // size, wp // size)
        out = self.attn(group(padded, size), *grid, key_mask)
        return ungroup(out, b, hp, wp, size)[:, :h, :w]

    def forward(self, x):
        """x: (B, H, W, C) -> the same."""
        b, h, w, c = x.shape
        y = self.norm1(x)
        dense = self._attend(y, min(self.window, h, w), windows, from_windows)
        sparse = self._attend(y, self.interval, intervals, from_intervals)
        fused = self.fusion(torch.cat([dense, sparse], -1).permute(0, 3, 1, 2))
        x = x.reshape(b, h * w, c) + fused.reshape(b, h * w, c)
        x = x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x.reshape(b, h, w, c)


class Net(nn.Module):
    def __init__(self, dim, n_blocks, num_heads, window_size, interval, mlp_ratio, u):
        super().__init__()
        c = u * dim
        self.to_feat = nn.Sequential(nn.Conv2d(3, dim // u, 3, padding=1), nn.PixelUnshuffle(u))
        self.feats = nn.Sequential(*[Block(c, num_heads, window_size, interval, mlp_ratio)
                                     for _ in range(n_blocks)])
        self.to_img = nn.Sequential(nn.Conv2d(c, 3 * u * u, 3, padding=1), nn.PixelShuffle(u))

    def forward(self, x):
        y0 = self.to_feat(x).permute(0, 2, 3, 1)
        y = self.feats(y0) + y0
        return self.to_img(y.permute(0, 3, 1, 2))


class ART(nn.Module):
    """x: (B, 3, H, W), H and W multiples of `upscaling_factor` -> the same."""

    def __init__(self, dim=48, n_blocks=8, num_heads=6, window_size=8, interval=16,
                 mlp_ratio=2.0, upscaling_factor=4):
        super().__init__()
        self.restoration_network = Net(dim, n_blocks, num_heads, window_size, interval, mlp_ratio,
                                       upscaling_factor)

    def forward(self, x):
        return self.restoration_network(x)


def from_config(cfg: dict) -> ART:
    """The reference model of a configuration file's `network_g`."""
    g = {k: v for k, v in cfg["network_g"].items() if k != "type"}
    return ART(**g)
