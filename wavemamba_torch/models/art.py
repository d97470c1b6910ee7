"""ART: the sparse / dense window-attention restoration transformer, the
second model family. The counterpart of `wavemamba_tpu/models/art.py`.

Each `TransformerBlock` runs dense window attention (G x G tiles) and sparse
interval attention (the tokens I apart) with one attention's weights and a
dynamic position bias, fuses the two with a 1x1 conv, then an MLP with
exact GELU. The network is a conv stem and a pixel-unshuffle, the blocks, a
global residual, and a conv and a pixel-shuffle. It runs no kernel of its
own (the JAX package computes all of it outside any Pallas kernel).

Each grouping's attention is one fused call (`fused_attention`) that never
holds the (groups, heads, N, N) scores: at a 2176x3840 bucket the sparse
groups hold 34 x 60 = 2,040 tokens, and the scores of one sparse call would
take 25.6 GB. The dynamic bias is the call's additive mask, gathered once a
call from the bias MLP's (2gh-1)(2gw-1) rows. Where a pad mask is live, the
groups fall into at most four pad classes (no pad, pad rows, pad columns,
both), and each class is one call whose mask is the bias plus the class's
pad keys, shared by the class's groups.

Spans (`utils/profiler.annotate`): `wm.art.pos_bias` (the bias MLP and its
gather), `wm.art.dense` and `wm.art.sparse` (grouping, the calls,
ungrouping), `wm.art.mlp` (the fusion conv and the MLP).

The module names are the JAX tree's (`restoration_network.to_feat.0`,
`feats.N.attn.pos.pos1.0`, ...), so `convert.state_dict_from_jax` carries an
`init_art` tree over. The model takes and returns NCHW, as `WaveMamba`
does; the blocks work on NHWC token grids, as the JAX blocks do.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from wavemamba_torch.ops.nn import (
    Conv2d,
    LayerNorm,
    Linear,
    init_conv2d,
    init_layer_norm,
    init_linear,
    network_apply,
    network_forward,
)
from wavemamba_torch.utils.profiler import annotate

NEG_INF = -1000000.0  # the pad masks' additive value (not -inf: a row of pads stays finite)


@dataclasses.dataclass(frozen=True)
class ARTConfig:
    dim: int = 48
    n_blocks: int = 8
    num_heads: int = 6
    window_size: int = 8
    interval: int = 16
    mlp_ratio: float = 2.0
    upscaling_factor: int = 4

    @property
    def out_dim(self) -> int:
        return self.upscaling_factor * self.dim


def _layer_norm(c):
    return LayerNorm(c, eps=1e-5, dim=-1)


class DynamicPosBias(nn.Module):
    """An MLP from a relative offset (dy, dx) to a bias per head."""

    def __init__(self, dim, num_heads):
        super().__init__()
        pos_dim = dim // 4
        self.pos_proj = Linear(2, pos_dim)
        stage = lambda cout: nn.Sequential(_layer_norm(pos_dim), nn.ReLU(),  # noqa: E731
                                           Linear(pos_dim, cout))
        self.pos1, self.pos2, self.pos3 = stage(pos_dim), stage(pos_dim), stage(num_heads)

    def forward(self, biases):
        return self.pos3(self.pos2(self.pos1(self.pos_proj(biases))))


@functools.lru_cache(maxsize=None)
def _relative_index(gh, gw):
    """The offsets ((2gh-1)(2gw-1), 2) of a gh x gw group and, for each pair
    of its tokens, the index of their offset (N*N,)."""
    bh = np.arange(1 - gh, gh)
    bw = np.arange(1 - gw, gw)
    biases = np.stack(np.meshgrid(bh, bw, indexing="ij")).reshape(2, -1).T
    ch, cw = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    coords = np.stack([ch, cw]).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    return biases.astype(np.float32), rel.sum(-1).reshape(-1)


def _row(n):
    """A mask row's length in memory: n rounded up to 16 values. The
    memory-efficient kernel wants every stride but the last a multiple of
    16 and copies a mask that has other strides, on every call."""
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=16)
def _device_index(gh, gw, device):
    """`_relative_index` on `device`, once for each (gh, gw, device): the
    offsets, and the index (N * _row(N),) of a bias whose rows are
    `_row(N)` long (the pad columns read offset 0 and are never used)."""
    biases, idx = _relative_index(gh, gw)
    n = gh * gw
    idx = np.pad(idx.reshape(n, n), ((0, 0), (0, _row(n) - n)))
    return torch.from_numpy(biases).to(device), torch.from_numpy(idx.reshape(-1)).to(device)


def fused_attention(q, k, v, mask):
    """softmax(q k^T + mask) v in one call that never holds the scores: q
    (B, heads, N, hd) already scaled, k and v alike, mask (1, heads, N, N)
    additive, shared by the batch. On CUDA the memory-efficient kernel
    alone (float32 with a float mask; the pin raises rather than fall back
    to the math route, which would build the scores), elsewhere torch's
    default route. Counts its calls in `fused_attention.calls`."""
    fused_attention.calls += 1
    if q.is_cuda:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)


fused_attention.calls = 0


class Attention(nn.Module):
    """Multi-head attention over grouped tokens with the dynamic relative
    position bias of the group's gh x gw grid."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.pos = DynamicPosBias(dim // 4, num_heads)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def bias_rows(self, gh, gw, device):
        """The dynamic bias (heads, N, _row(N)): the bias MLP over the
        group's offsets, gathered for each pair of its tokens; the values
        past N in a row are not used."""
        biases, idx = _device_index(gh, gw, device)
        n = gh * gw
        return self.pos(biases).t()[:, idx].view(self.num_heads, n, _row(n))

    def relative_bias(self, gh, gw, device):
        """(heads, N, N)."""
        return self.bias_rows(gh, gw, device)[:, :, :gh * gw]

    def forward(self, x, gh, gw, key_pad=None):
        """x: (B_, N, C) grouped tokens, batch-major (B_ = batch x groups);
        key_pad: (groups, N) bool numpy, True at a pad token, or None."""
        b_, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (hd**-0.5), qkv[1], qkv[2]
        with annotate("wm.art.pos_bias"):
            rows = self.bias_rows(gh, gw, x.device)
        if key_pad is None:
            out = fused_attention(q, k, v, rows[None, :, :, :n])
        else:
            out = _by_pad_class(q, k, v, rows, key_pad)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


def _by_pad_class(q, k, v, rows, key_pad):
    """`fused_attention` once for each pad class of groups (the groups whose
    pad keys are the same), its mask the bias `rows` plus NEG_INF at the
    class's pad keys. q, k, v: (batch x groups, heads, N, hd)."""
    b_, heads, n, hd = q.shape
    groups = key_pad.shape[0]
    # One opaque value a row: np.unique(axis=0) would compare the rows a
    # field (a token) at a time, ~0.2 s at the 2176x3840 bucket's shapes.
    as_bytes = np.ascontiguousarray(key_pad).view(np.dtype((np.void, key_pad.shape[1])))
    _, first, of_group = np.unique(as_bytes[:, 0], return_index=True, return_inverse=True)
    classes = key_pad[first]

    def mask(pads):
        keys = np.zeros(rows.shape[-1], np.float32)
        keys[:n] = np.where(pads, NEG_INF, 0.0)
        return (rows + torch.from_numpy(keys).to(q.device))[None, :, :, :n]

    if len(classes) == 1:
        return fused_attention(q, k, v, mask(classes[0]))
    split = lambda t: t.reshape(b_ // groups, groups, heads, n, hd)  # noqa: E731
    q5, k5, v5 = split(q), split(k), split(v)
    out = torch.empty_like(q5)
    for cls, pads in enumerate(classes):
        idx = torch.from_numpy(np.flatnonzero(of_group == cls)).to(q.device)
        pick = lambda t: t[:, idx].reshape(-1, heads, n, hd)  # noqa: E731
        out[:, idx] = fused_attention(pick(q5), pick(k5), pick(v5), mask(pads)).view(
            b_ // groups, len(idx), heads, n, hd)
    return out.reshape(b_, heads, n, hd)


def attention_by_scores(attn, x, gh, gw, key_pad=None):
    """`attn(x, gh, gw, key_pad)` as the JAX package writes it, with every
    score built: the formula that the fused route is held to, by the tests
    and on the card by `chip_smoke.py`. Not for serving: at the 2176x3840
    bucket the scores of one sparse call take 25.6 GB."""
    b_, n, c = x.shape
    heads = attn.num_heads
    hd = c // heads
    q, k, v = attn.qkv(x).reshape(b_, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = (q * hd**-0.5) @ k.transpose(-2, -1) + attn.relative_bias(gh, gw, x.device)[None]
    if key_pad is not None:
        groups = key_pad.shape[0]
        mask = torch.where(torch.from_numpy(key_pad).to(x.device), NEG_INF, 0.0)[:, None, :]
        s = s.reshape(b_ // groups, groups, heads, n, n) + mask[None, :, None].to(s.dtype)
        s = s.reshape(b_, heads, n, n)
    return attn.proj((s.softmax(-1) @ v).transpose(1, 2).reshape(b_, n, c))


def _pad_mask(x, size):
    """Zero-pad NHWC bottom / right to a multiple of `size`: (padded x, the
    pad mask (1, H, W, 1) numpy, -1 in the pad, pad_b, pad_r)."""
    _, h, w, _ = x.shape
    pad_b, pad_r = (-h) % size, (-w) % size
    xp = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    mask = np.zeros((1, h + pad_b, w + pad_r, 1), np.float32)
    if pad_b:
        mask[:, -pad_b:] = -1
    if pad_r:
        mask[:, :, -pad_r:] = -1
    return xp, mask, pad_b, pad_r


class Mlp(nn.Module):
    def __init__(self, c, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(c, hidden), Linear(hidden, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) GELU


class TransformerBlock(nn.Module):
    """Dense and sparse attention with shared weights, fused; then the MLP."""

    def __init__(self, cfg: ARTConfig):
        super().__init__()
        c = cfg.out_dim
        hidden = int(c * cfg.mlp_ratio)
        self.cfg = cfg
        self.norm1 = _layer_norm(c)
        self.attn = Attention(c, cfg.num_heads)
        self.fusion = Conv2d(2 * c, c, 1)
        self.norm2 = _layer_norm(c)
        self.mlp = Mlp(c, hidden)

    def forward(self, x):
        """x: (B, H, W, C) -> the same."""
        b, h, w, c = x.shape
        xn = self.norm1(x)

        with annotate("wm.art.dense"):  # window attention
            g = min(self.cfg.window_size, h, w)
            xd, md, pad_b, pad_r = _pad_mask(xn, g)
            hd_, wd_ = xd.shape[1:3]
            npd = (hd_ // g) * (wd_ // g)
            xd = xd.reshape(b, hd_ // g, g, wd_ // g, g, c).permute(0, 1, 3, 2, 4, 5)
            key_pad = None
            if pad_b or pad_r:
                md = md.reshape(1, hd_ // g, g, wd_ // g, g, 1).transpose(0, 1, 3, 2, 4, 5)
                key_pad = md.reshape(npd, g * g) < 0
            xd = self.attn(xd.reshape(b * npd, g * g, c), g, g, key_pad)
            xd = xd.reshape(b, hd_ // g, wd_ // g, g, g, c).permute(0, 1, 3, 2, 4, 5)
            xd = xd.reshape(b, hd_, wd_, c)[:, :h, :w]

        with annotate("wm.art.sparse"):  # interval attention
            i = self.cfg.interval
            xs, ms, pad_b, pad_r = _pad_mask(xn, i)
            hs, ws = xs.shape[1:3]
            gh, gw = hs // i, ws // i
            xs = xs.reshape(b, gh, i, gw, i, c).permute(0, 2, 4, 1, 3, 5)
            key_pad = None
            if pad_b or pad_r:
                ms = ms.reshape(1, gh, i, gw, i, 1).transpose(0, 2, 4, 1, 3, 5)
                key_pad = ms.reshape(i * i, gh * gw) < 0
            xs = self.attn(xs.reshape(b * i * i, gh * gw, c), gh, gw, key_pad)
            xs = xs.reshape(b, i, i, gh, gw, c).permute(0, 3, 1, 4, 2, 5)
            xs = xs.reshape(b, hs, ws, c)[:, :h, :w]

        with annotate("wm.art.mlp"):
            fused = self.fusion(torch.cat([xd, xs], -1).permute(0, 3, 1, 2))
            # The reference reads the NCHW fusion output as (B, H*W, C) tokens
            # without a permute, which scrambles channels across tokens; trained
            # checkpoints bake it in. `reshape` follows the logical NCHW order
            # whatever the output's memory format, as the reference's `.view` of
            # a contiguous NCHW tensor does.
            x = x.reshape(b, h * w, c) + fused.reshape(b, h * w, c)
            return (x + self.mlp(self.norm2(x))).reshape(b, h, w, c)


class Net(nn.Module):
    def __init__(self, cfg: ARTConfig):
        super().__init__()
        u = cfg.upscaling_factor
        self.to_feat = nn.Sequential(Conv2d(3, cfg.dim // u, 3, padding=1), nn.PixelUnshuffle(u))
        self.feats = nn.Sequential(*[TransformerBlock(cfg) for _ in range(cfg.n_blocks)])
        self.to_img = nn.Sequential(Conv2d(cfg.out_dim, 3 * u * u, 3, padding=1),
                                    nn.PixelShuffle(u))

    def forward(self, x):
        y0 = self.to_feat(x).permute(0, 2, 3, 1)
        y = self.feats(y0) + y0
        return self.to_img(y.permute(0, 3, 1, 2))


class ART(nn.Module):
    """The network under `restoration_network`, as the reference's wrapper.
    x: (B, 3, H, W), H and W multiples of `upscaling_factor` -> the same."""

    def __init__(self, cfg: ARTConfig = ARTConfig()):
        super().__init__()
        self.cfg = cfg
        self.restoration_network = Net(cfg)

    def forward(self, x):
        return self.restoration_network(x)


def init_art(model: ART, generator) -> ART:
    """Fill every parameter from `generator` with the distributions of the
    JAX package's `init_art` (torch's defaults for convolutions and linear
    layers, norms at 1 and 0)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            init_conv2d(m, generator)
        elif isinstance(m, nn.Linear):
            init_linear(m, generator)
        elif isinstance(m, LayerNorm):
            init_layer_norm(m)
    return model


# x: (B, H, W, 3) NHWC, H and W multiples of `upscaling_factor` -> the same,
# float32 (JAX's `art_apply`); differentiable, and without a gradient.
art_forward, art_apply = network_forward, network_apply
