"""WaveMamba: the wavelet state-space U-Net for UHD low-light enhancement.

The counterpart of `wavemamba_tpu/models/wavemamba.py`. Modules are
NCHW inside, the reference's own layout, and their attribute names are the
`.pth` keys, so `load_state_dict(strict=True)` takes the shipped checkpoints
as they are. `wavemamba_apply` (inference, no gradient) and
`wavemamba_forward` (differentiable) keep the JAX package's NHWC layout at
the boundary. `init_wavemamba` fills a model from a `torch.Generator` with
the JAX package's `init_*` distributions.

With `scan_impl='pallas_fused'` (the default) SS2D runs its four directional
scans as two direction pairs (rows: directions 0 and 2, columns: 1 and 3)
through `ops/scan_cuda.py:ss2d_scan_pair`: kernel K1, and under autograd K2 as
its backward, on a CUDA tensor; their plain versions on a CPU tensor. Every
other `scan_impl` takes the unfused route: four materialised direction
streams, the stacked x_proj / dt_proj einsums, then `ops/scan.py:
selective_scan`, whose 'pallas' route is kernels K3 / K4.

With `conv_impl='fused'` (inference only) the model's conv chains run as
the JAX package's fused chains do (`experimental/conv_fused.py`): SS2D's
depthwise conv + silu, LFSS's whole second half-block, HFE's qkv, PAConv and
FeedForward chains (the block's norm1 / norm2 folded into the first chain of
each half-block) and the eight single dense 3x3 convs, 76 chains a forward at
the shipped depth, each one launch of kernel K7 on a CUDA tensor. The chains'
GELU is the tanh form; the stock route keeps the exact erf. Under
`compute_dtype='bfloat16'` the chains take and return the bf16 activations,
computing in float32 between, as the JAX package's do.

With `compute_dtype='bfloat16'` the network runs in bf16 as the JAX model
does: parameters stay float32 and each conv, linear, PReLU slope, skip scale
and attention temperature is cast to the activation's dtype (`ops/nn.py`);
LayerNorm keeps float32 statistics, the channel matching float32 distances,
the scans float32 parameters and state; the Haar DWT and the pixel-unshuffle
pyramid take their conv forms (`dwt2_conv`, `_ps_down`), and every 1x1
conv outside the regions that `conv1x1_as_conv` names is a token matmul, as
in the JAX model. `scan_dtype` is the dtype of the scans' y: bf16 y is
summed over the directions in bf16. `WaveMamba.forward` casts the input to
`compute_dtype` and the output back. `WaveMambaConfig.fast()` and its siblings are the JAX
package's presets.

With `cfg.remat` every LFSS and HFE block runs under
`torch.utils.checkpoint`: the backward pass recomputes the block's forward
instead of keeping its activations, under `cfg.remat_policy`, as the JAX
package's `_maybe_remat` does. 'save_scan' (the default) keeps the outputs of
the fused scan's op (`scan_cuda.ss2d_scan_pair_fwd`: y, the chunk-entry
states and the chunks' sums of da) from the block's forward, and the
recompute takes them back (`scan_cuda.save_scan_contexts`) while it
recomputes everything else, so K1 runs once a step; with any other
`scan_impl`, and in HFE blocks (which hold no scan), it recomputes the whole
block, as 'full' always does, K1 included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from wavemamba_torch.experimental import conv_fused as cf
from wavemamba_torch.models.buckets import pad_to_shape
from wavemamba_torch.ops.haar import dwt2, dwt2_conv, iwt2_cat
from wavemamba_torch.ops.nn import (
    Conv2d,
    LayerNorm,
    Linear,
    PReLU,
    _fan_in_uniform,
    init_conv2d,
    init_layer_norm,
    init_linear,
    l2_normalize,
    network_apply,
    network_forward,
)
from wavemamba_torch.ops.scan import selective_scan
from wavemamba_torch.ops.scan_cuda import save_scan_contexts, ss2d_scan_pair

_ROWS, _COLS = [0, 2], [1, 3]  # direction pairs: row-major and column-major fwd/rev
SCAN_IMPLS = ("pallas_fused", "pallas", "chunked", "par", "ref", "seq_sharded")
CONV_IMPLS = ("xla", "fused")
REMAT_POLICIES = ("save_scan", "full")
CONV1X1_REGIONS = ("ffn", "hfe")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class WaveMambaConfig:
    """Architecture of the shipped model (`wavemamba_tpu` defaults).

    `scan_impl` keeps the JAX package's names, so its option files select the
    same routes here: 'pallas_fused' is kernels K1 / K2, 'pallas' kernels K3 /
    K4, 'chunked' | 'par' | 'ref' plain torch ops, 'seq_sharded' the
    'chunked' scan with its token axis split over the ranks of `scan_mesh`
    (`parallel/seq_scan.py`; it trains with every rank on the same rows,
    `train/trainer.py`). The default is
    'pallas_fused', not the JAX package's 'chunked': on the card the entry
    points launch a kernel by default, and every `options/*.yml` sets it.

    `compute_dtype` and `scan_dtype` keep the JAX package's meaning: the
    dtype the network runs in, and the dtype of the scans' y (and of the
    working arrays of 'chunked' and 'par'); the scans' state math is float32
    on the kernel routes. 'float32' is the parity mode."""

    in_chn: int = 3
    wf: int = 32
    n_l_blocks: Sequence[int] = (1, 2, 4)
    n_h_blocks: Sequence[int] = (1, 1, 2)
    ffn_scale: float = 2.0
    d_state: int = 16
    d_conv: int = 3
    ffn_restormer: bool = False
    # Execution knobs, not part of the checkpoint. The scan's route, the chunk
    # of 'chunked' and the subsegment of 'par' (the kernels have their own
    # chunk, `scan_cuda.CHUNK`).
    scan_impl: str = "pallas_fused"
    scan_chunk: int = 256
    scan_sub: int = 32
    # For scan_impl='seq_sharded': the `DeviceMesh` (`parallel.make_mesh()`)
    # whose axis `scan_mesh_axis` the token axis L is split over. The other
    # routes ignore them.
    scan_mesh: object = None
    scan_mesh_axis: str = "data"
    # Recompute every LFSS and HFE block in the backward pass instead of
    # keeping its activations; 'save_scan' keeps the fused scan's outputs
    # across the recompute, 'full' recomputes everything (see the module
    # docstring).
    remat: bool = True
    remat_policy: str = "save_scan"
    # 'fused' runs the conv chains as fused chain kernels (K7), inference
    # only; 'xla' (the JAX package's name) is the stock, differentiable route.
    conv_impl: str = "xla"
    # 'bfloat16' runs convs, matmuls and activations in bf16; 'float32' is the
    # parity mode. The scans' y (and 'chunked' / 'par' working arrays) in
    # `scan_dtype`.
    compute_dtype: str = "float32"
    scan_dtype: str = "float32"
    # Regions whose 1x1 convs stay convs off float32 ('ffn': the LFSS FFN's
    # conv1 / conv3; 'hfe': the HFE blocks' qkv, PAConv k2 and FeedForward
    # 1x1s). Every other 1x1 conv lowers to a token matmul there, as the JAX
    # package's `conv2d` does (`ops/nn.py:Conv2d`); float32 keeps the convs.
    conv1x1_as_conv: Sequence[str] = ()

    @classmethod
    def fast(cls, **kw):
        """The bf16 inference preset: `fast_tpu()` on every device. The JAX
        package's `fast()` turns into `fast_xla()` off a TPU; the port has no
        such switch. On the card it launches K1 on bf16 token streams; on the
        CPU the kernels' plain versions take the same preset."""
        return cls.fast_tpu(**kw)

    @classmethod
    def fast_tpu(cls, **kw):
        """bf16 convs and matmuls, the fused scan (K1, K2 under autograd) with
        float32 state and bf16 y. `scan_chunk` is 512 as in the JAX preset;
        the port's kernels keep their own chunk (`scan_cuda.CHUNK`)."""
        kw.setdefault("scan_impl", "pallas_fused")
        kw.setdefault("compute_dtype", "bfloat16")
        kw.setdefault("scan_dtype", "bfloat16")
        kw.setdefault("scan_chunk", 512)
        return cls(**kw)

    @classmethod
    def fast_train(cls, **kw):
        """The bf16 training preset: `fast_tpu()` with `scan_chunk` 128."""
        kw.setdefault("scan_chunk", 128)
        return cls.fast_tpu(**kw)

    @classmethod
    def fast_xla(cls, **kw):
        """bf16 with no kernel: the 'par' scan on bf16 working arrays."""
        kw.setdefault("scan_impl", "par")
        kw.setdefault("scan_sub", 32)
        kw.setdefault("compute_dtype", "bfloat16")
        kw.setdefault("scan_dtype", "bfloat16")
        return cls(**kw)

    def __post_init__(self):
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"unknown scan_impl {self.scan_impl!r}; known: {SCAN_IMPLS}")
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {self.conv_impl!r}; known: {CONV_IMPLS}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; known: {REMAT_POLICIES}")
        for key in ("compute_dtype", "scan_dtype"):
            if getattr(self, key) not in DTYPES:
                raise ValueError(f"unknown {key} {getattr(self, key)!r}; known: {tuple(DTYPES)}")
        regions = self.conv1x1_as_conv
        if isinstance(regions, str) or not set(regions) <= set(CONV1X1_REGIONS):
            raise ValueError(f"conv1x1_as_conv takes a list of regions out of {CONV1X1_REGIONS}, "
                             f"got {regions!r}")

    @property
    def d_inner(self) -> int:
        return int(self.ffn_scale * self.wf)

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.wf / 16)


def _scan_directions(x):
    """x: (B, H, W, D) -> (B, 4, L, D): row-major, column-major, then both
    reversed (the reference's direction order)."""
    b, h, w, d = x.shape
    k0 = x.reshape(b, h * w, d)
    k1 = x.transpose(1, 2).reshape(b, h * w, d)
    return torch.stack([k0, k1, k0.flip(1), k1.flip(1)], 1)


def _merge_directions(y, h, w):
    """y: (B, 4, L, D) scan outputs -> (B, H, W, D): the sum of the four,
    each brought back to row-major token order."""
    b, _, _, d = y.shape
    cols = lambda t: t.view(b, w, h, d).transpose(1, 2)
    rows = lambda t: t.view(b, h, w, d)
    return rows(y[:, 0]) + cols(y[:, 1]) + rows(y[:, 2].flip(1)) + cols(y[:, 3].flip(1))


class SS2D(nn.Module):
    """2-D selective scan: four directional 1-D scans over the token grid."""

    def __init__(self, cfg: WaveMambaConfig):
        super().__init__()
        self.scan_impl, self.scan_chunk, self.scan_sub = cfg.scan_impl, cfg.scan_chunk, cfg.scan_sub
        self.scan_mesh, self.scan_mesh_axis = cfg.scan_mesh, cfg.scan_mesh_axis
        self.scan_dtype = DTYPES[cfg.scan_dtype]
        self.conv_fused = cfg.conv_impl == "fused" and cfg.d_conv == 3
        c, d, n, r = cfg.wf, cfg.d_inner, cfg.d_state, cfg.dt_rank
        self.in_proj = Linear(c, 2 * d, bias=False)
        self.conv2d = Conv2d(d, d, cfg.d_conv, padding=(cfg.d_conv - 1) // 2, groups=d)
        self.x_proj_weight = nn.Parameter(torch.zeros(4, r + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.zeros(4, d, r))
        self.dt_projs_bias = nn.Parameter(torch.zeros(4, d))
        self.A_logs = nn.Parameter(torch.zeros(4 * d, n))
        self.Ds = nn.Parameter(torch.ones(4 * d))
        self.out_norm = LayerNorm(d, eps=1e-5, dim=-1)
        self.out_proj = Linear(d, c, bias=False)
        self.scan = ss2d_scan_pair  # the fused route's scan, see `set_scan`
        self.unfused_scan = None  # the unfused route's, see `set_unfused_scan`

    def forward(self, x):
        """x: (B, C, H, W) -> (B, C, H, W)."""
        b, _, h, w = x.shape
        d = self.conv2d.in_channels
        xx, z = self.in_proj(x.permute(0, 2, 3, 1)).chunk(2, dim=-1)  # (B, H, W, D)
        xx = xx.permute(0, 3, 1, 2)  # (B, D, H, W), a view
        xx = cf.dw_act(self.conv2d, xx, "silu") if self.conv_fused else F.silu(self.conv2d(xx))
        y = self._fused(xx) if self.scan_impl == "pallas_fused" else self._unfused(xx)
        y = self.out_norm(y) * F.silu(z)
        return self.out_proj(y).permute(0, 3, 1, 2)

    def _unfused(self, xx):
        """xx: (B, D, H, W) -> (B, H, W, D) in xx's dtype: the four direction
        streams and their projections in memory (in xx's dtype), then
        `selective_scan`."""
        b, d, h, w = xx.shape
        r, n = self.dt_projs_weight.shape[2], self.A_logs.shape[1]
        xs = _scan_directions(xx.permute(0, 2, 3, 1))  # (B, 4, L, D)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight.to(xs.dtype))
        dts = torch.einsum("bklr,kdr->bkld", x_dbl[..., :r], self.dt_projs_weight.to(xs.dtype))
        args = (xs, dts.contiguous(), -torch.exp(self.A_logs.float()).view(4, d, n),
                x_dbl[..., r:r + n].contiguous(), x_dbl[..., r + n:].contiguous(),
                self.Ds.view(4, d), self.dt_projs_bias)
        if self.unfused_scan is not None:
            y = self.unfused_scan(*args)
        elif self.scan_impl == "seq_sharded":
            y = self._seq_sharded(*args)
        else:
            y = selective_scan(*args, impl=self.scan_impl, chunk=self.scan_chunk,
                               sub=self.scan_sub, scan_dtype=self.scan_dtype)
        return _merge_directions(y, h, w).to(xx.dtype)

    def _seq_sharded(self, xs, dts, A, Bs, Cs, Ds, bias):
        """The scan with L split over `scan_mesh`, as the JAX model runs it:
        L zero-padded to a multiple of the axis size (padded tokens come
        after every real one, so no real output sees them), the padding
        dropped after."""
        from wavemamba_torch.parallel.mesh import axis_size
        from wavemamba_torch.parallel.seq_scan import selective_scan_seq_sharded

        if self.scan_mesh is None:
            raise ValueError("scan_impl='seq_sharded' requires cfg.scan_mesh "
                             "(wavemamba_torch.parallel.make_mesh())")
        length = xs.shape[2]
        pad = (-length) % axis_size(self.scan_mesh, self.scan_mesh_axis)
        if pad:
            xs, dts, Bs, Cs = (F.pad(t, (0, 0, 0, pad)) for t in (xs, dts, Bs, Cs))
        return selective_scan_seq_sharded(xs, dts, A, Bs, Cs, Ds, bias, self.scan_mesh,
                                          axis=self.scan_mesh_axis, chunk=self.scan_chunk,
                                          scan_dtype=self.scan_dtype)[:, :, :length]

    def _fused(self, xx):
        """xx: (B, D, H, W) -> (B, H, W, D) in xx's dtype: two direction pairs
        through `ss2d_scan_pair`, which projects inside the kernel and writes y
        in `scan_dtype`; the four are summed in that dtype."""
        b, d, h, w = xx.shape
        A = -torch.exp(self.A_logs.float()).view(4, d, -1).transpose(1, 2)  # (4, N, D)
        wx = self.x_proj_weight.transpose(1, 2)  # (4, D, R+2N)
        dtw = self.dt_projs_weight.transpose(1, 2)  # (4, R, D)
        dsk = self.Ds.view(4, d)

        def pair(tokens, k):
            return self.scan(tokens, wx[k].contiguous(), dtw[k].contiguous(),
                             self.dt_projs_bias[k].contiguous(), A[k].contiguous(),
                             dsk[k].contiguous(), out_dtype=self.scan_dtype)

        pr = pair(xx.permute(0, 2, 3, 1).reshape(b, h * w, d).contiguous(), _ROWS)
        pc = pair(xx.permute(0, 3, 2, 1).reshape(b, w * h, d).contiguous(), _COLS)
        y = (pr[:, 0] + pr[:, 1]).view(b, h, w, d) \
            + (pc[:, 0] + pc[:, 1]).view(b, w, h, d).transpose(1, 2)
        return y.to(xx.dtype)


class FFN(nn.Module):
    """NAFNet-style gated FFN (`ffn`)."""

    def __init__(self, c, expand=2, as_conv=False):
        super().__init__()
        dw = c * expand
        self.conv1 = Conv2d(c, dw, 1, as_conv=as_conv)
        self.conv2 = Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = Conv2d(dw // 2, c, 1, as_conv=as_conv)

    def forward(self, x):
        y1, y2 = self.conv2(self.conv1(x)).chunk(2, dim=1)
        return self.conv3(F.gelu(y1) * y2)


class LFSSBlock(nn.Module):
    def __init__(self, cfg: WaveMambaConfig):
        super().__init__()
        c = cfg.wf
        self.ln_1 = LayerNorm(c, eps=1e-6)
        self.self_attention = SS2D(cfg)
        self.skip_scale = nn.Parameter(torch.ones(c))
        self.ln_2 = LayerNorm(c, eps=1e-5)
        self.conv_blk = FFN(c, as_conv="ffn" in cfg.conv1x1_as_conv)
        self.skip_scale2 = nn.Parameter(torch.ones(c))
        self.conv_fused = cfg.conv_impl == "fused"

    def forward(self, x):
        x = x * self.skip_scale.to(x.dtype).view(1, -1, 1, 1) + self.self_attention(self.ln_1(x))
        if self.conv_fused:  # the whole second half-block in one chain
            return cf.lfss_ffn_block(self.ln_2, self.conv_blk, self.skip_scale2, x)
        return x * self.skip_scale2.to(x.dtype).view(1, -1, 1, 1) + self.conv_blk(self.ln_2(x))


def matching(x, perc):
    """For each channel of x, the channel of `perc` nearest in L2 over the
    flattened spatial map (match_factor=1). x, perc: (B, C, H, W)."""
    b, c, h, w = x.shape
    with torch.no_grad():  # the argmin carries no gradient; the gather below does
        xf = x.reshape(b, c, h * w).float()
        pf = perc.reshape(b, c, h * w).float()
        d2 = (xf * xf).sum(-1)[:, :, None] + (pf * pf).sum(-1)[:, None, :] \
            - 2.0 * torch.bmm(xf, pf.transpose(1, 2))
        idx = d2.argmin(-1)  # (B, C)
    sel = torch.gather(perc.reshape(b, c, h * w), 1, idx[:, :, None].expand(b, c, h * w))
    return sel.view(b, c, h, w)


class PAConv(nn.Module):
    def __init__(self, nf, conv_fused=False, as_conv=False):
        super().__init__()
        self.k2 = Conv2d(nf, nf, 1, as_conv=as_conv)
        self.k3 = Conv2d(nf, nf, 3, padding=1, bias=False)
        self.k4 = Conv2d(nf, nf // 2, 3, padding=1, bias=False)
        self.conv_fused = conv_fused

    def forward(self, x):
        if self.conv_fused:
            return cf.paconv_chain(self, x)
        return self.k4(self.k3(x) * torch.sigmoid(self.k2(x)))


class MatchingTransformation(nn.Module):
    def __init__(self, c, conv_fused=False, as_conv=False):
        super().__init__()
        self.paconv = PAConv(2 * c, conv_fused, as_conv)

    def forward(self, x, perc):
        return self.paconv(torch.cat([x, matching(x, perc)], dim=1))


class CMTAttention(nn.Module):
    """Transposed (channel) attention with perception-matched queries."""

    def __init__(self, c, num_heads=1, conv_fused=False, as_conv=False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv2d(c, 3 * c, 1, as_conv=as_conv)
        self.qkv_dwconv = Conv2d(3 * c, 3 * c, 3, padding=1, groups=3 * c)
        # its input comes from the attention's product: a matmul in any region
        self.project_out = Conv2d(c, c, 1)
        self.matching_transformation = MatchingTransformation(c, conv_fused, as_conv)
        self.conv_fused = conv_fused

    def forward(self, x, perc, ln=None):
        """`ln`, a LayerNorm folded into the fused qkv chain (conv_fused only)."""
        b, c, h, w = x.shape
        qkv = cf.qkv_chain(self, x, ln=ln) if self.conv_fused else self.qkv_dwconv(self.qkv(x))
        q, k, v = qkv.chunk(3, dim=1)
        q = self.matching_transformation(q, perc)

        def heads(t):  # (B, C, H, W) -> (B, heads, C/heads, L)
            return t.reshape(b, self.num_heads, c // self.num_heads, h * w)

        q, k, v = l2_normalize(heads(q)), l2_normalize(heads(k)), heads(v)
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature.to(q.dtype), dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class FeedForward(nn.Module):
    def __init__(self, c, conv_fused=False, as_conv=False):
        super().__init__()
        self.project_in = nn.Sequential(Conv2d(c, c, 1, as_conv=as_conv),
                                        Conv2d(c, c, 3, padding=1, groups=c))
        self.matching_transformation = MatchingTransformation(c, conv_fused, as_conv)
        self.project_out = nn.Sequential(Conv2d(c, c, 3, padding=1, groups=c), nn.GELU(),
                                         Conv2d(c, c, 1, as_conv=as_conv))
        self.conv_fused = conv_fused

    def forward(self, x, perc, ln=None):
        """`ln`, a LayerNorm folded into the fused project_in chain (conv_fused only)."""
        if self.conv_fused:
            y = self.matching_transformation(cf.ff_in_chain(self.project_in, x, ln=ln), perc)
            return cf.ff_out_chain(self.project_out, y)
        return self.project_out(self.matching_transformation(self.project_in(x), perc))


class FeedForwardRestormer(nn.Module):
    def __init__(self, c, expand=1, conv_fused=False):
        super().__init__()
        hidden = int(c * expand)
        self.project_in = Conv2d(c, 2 * hidden, 1)
        self.dwconv = Conv2d(2 * hidden, 2 * hidden, 3, padding=1, groups=2 * hidden)
        self.project_out = Conv2d(hidden, c, 1)
        self.conv_fused = conv_fused

    def forward(self, x, perc=None):
        if self.conv_fused:
            return cf.restormer_chain(self, x)
        y1, y2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(y1) * y2)


class HFEBlock(nn.Module):
    """`as_conv`: the 'hfe' region of `conv1x1_as_conv` (the Restormer FFN's
    1x1s stay matmuls off float32, as in the JAX model)."""

    def __init__(self, c, ffn_restormer=False, conv_fused=False, as_conv=False):
        super().__init__()
        self.norm1 = LayerNorm(c, eps=1e-6)
        self.attn = CMTAttention(c, conv_fused=conv_fused, as_conv=as_conv)
        self.norm2 = LayerNorm(c, eps=1e-6)
        self.LayerNorm = LayerNorm(c, eps=1e-6)
        self.ffn = (FeedForwardRestormer(c, conv_fused=conv_fused) if ffn_restormer
                    else FeedForward(c, conv_fused, as_conv))
        self.conv_fused = conv_fused

    def forward(self, x, perc):
        perc = self.LayerNorm(perc)
        if self.conv_fused:  # norm1 / norm2 fold into the first chain of each half-block
            x = x + self.attn(x, perc, ln=self.norm1)
            if isinstance(self.ffn, FeedForwardRestormer):
                return cf.restormer_chain(self.ffn, x, ln=self.norm2, residual=True)
            return x + self.ffn(x, perc, ln=self.norm2)
        x = x + self.attn(self.norm1(x), perc)
        return x + self.ffn(self.norm2(x), perc)


class SKFF(nn.Module):
    """Selective kernel fusion of the three high-frequency subbands."""

    def __init__(self, c, height=3, reduction=8):
        super().__init__()
        d = max(c // reduction, 4)
        self.conv_du = nn.Sequential(Conv2d(c, d, 1, bias=False), PReLU())
        self.fcs = nn.ModuleList(Conv2d(d, c, 1, bias=False) for _ in range(height))

    def forward(self, feats):
        u = feats[0]
        for f in feats[1:]:
            u = u + f
        z = self.conv_du(u.mean(dim=(2, 3), keepdim=True))
        att = torch.softmax(torch.stack([fc(z) for fc in self.fcs], 0), dim=0)
        out = att[0] * feats[0]
        for i in range(1, len(feats)):
            out = out + att[i] * feats[i]
        return out


def _conv3x3(conv, x, conv_fused):
    """A dense 3x3 conv: the fused chain route's single-stage chain, or the module."""
    return cf.dense3x3(conv, x) if conv_fused else conv(x)


def _remat(cfg: WaveMambaConfig, has_scan: bool):
    """How a block recomputes: None (it does not), 'full', or 'save_scan'
    where the block holds the fused scan (`_maybe_remat` of the JAX model)."""
    if not cfg.remat:
        return None
    if cfg.remat_policy == "save_scan" and has_scan and cfg.scan_impl == "pallas_fused":
        return "save_scan"
    return "full"


def _run_block(blk, remat, *args):
    """`blk(*args)`, recomputed in the backward pass as `remat` (`_remat`) says."""
    if remat is None or not torch.is_grad_enabled():
        return blk(*args)
    context = {"context_fn": save_scan_contexts} if remat == "save_scan" else {}
    return checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False, **context)


class DownFRG(nn.Module):
    def __init__(self, cfg: WaveMambaConfig, n_l, n_h):
        super().__init__()
        c = cfg.wf
        self.l_remat, self.h_remat = _remat(cfg, True), _remat(cfg, False)
        self.l_conv = Conv2d(2 * c, c, 3, padding=1)
        self.l_blk = nn.ModuleList(LFSSBlock(cfg) for _ in range(n_l))
        self.h_fusion = SKFF(c)
        self.conv_fused = cfg.conv_impl == "fused"
        self.h_blk = nn.ModuleList(HFEBlock(c, cfg.ffn_restormer, self.conv_fused,
                                            "hfe" in cfg.conv1x1_as_conv) for _ in range(n_h))
        # bf16 takes the conv form of the DWT, as the JAX model does: the two
        # round differently.
        self.haar = dwt2 if cfg.compute_dtype == "float32" else dwt2_conv

    def forward(self, x, x_d):
        ll, hl, lh, hh = self.haar(x)
        ll = _conv3x3(self.l_conv, torch.cat([ll, x_d], dim=1), self.conv_fused)
        for blk in self.l_blk:
            ll = _run_block(blk, self.l_remat, ll)
        xh = self.h_fusion([hl, lh, hh])
        for blk in self.h_blk:
            xh = _run_block(blk, self.h_remat, xh, ll)
        return ll, xh


class UpFRG(nn.Module):
    def __init__(self, cfg: WaveMambaConfig, n_l, n_h):
        super().__init__()
        c = cfg.wf
        self.l_remat, self.h_remat = _remat(cfg, True), _remat(cfg, False)
        self.l_blk = nn.ModuleList(LFSSBlock(cfg) for _ in range(n_l))
        self.h_out_conv = Conv2d(c, 3 * c, 3, padding=1)
        self.conv_fused = cfg.conv_impl == "fused"
        self.h_blk = nn.ModuleList(HFEBlock(c, cfg.ffn_restormer, self.conv_fused,
                                            "hfe" in cfg.conv1x1_as_conv) for _ in range(n_h))

    def forward(self, x_l, x_h):
        for blk in self.l_blk:
            x_l = _run_block(blk, self.l_remat, x_l)
        for blk in self.h_blk:
            x_h = _run_block(blk, self.h_remat, x_h, x_l)
        return iwt2_cat(torch.cat([x_l, _conv3x3(self.h_out_conv, x_h, self.conv_fused)], dim=1))


class UNet(nn.Module):
    def __init__(self, cfg: WaveMambaConfig):
        super().__init__()
        c, ic = cfg.wf, cfg.in_chn
        nl, nh = cfg.n_l_blocks, cfg.n_h_blocks
        self.ps_down1 = nn.Sequential(nn.PixelUnshuffle(2), Conv2d(4 * ic, c, 1))
        self.ps_down2 = nn.Sequential(nn.PixelUnshuffle(4), Conv2d(16 * ic, c, 1))
        self.ps_down3 = nn.Sequential(nn.PixelUnshuffle(8), Conv2d(64 * ic, c, 1))
        self.conv_01 = Conv2d(ic, c, 3, padding=1)
        self.down_group1 = DownFRG(cfg, nl[0], nh[0])
        self.down_group2 = DownFRG(cfg, nl[1], nh[1])
        self.down_group3 = DownFRG(cfg, nl[2], nh[2])
        self.up_group3 = UpFRG(cfg, nl[2], nh[2])
        self.up_group2 = UpFRG(cfg, nl[1], nh[1])
        self.up_group1 = UpFRG(cfg, nl[0], nh[0])
        self.last = Conv2d(c, ic, 3, padding=1)
        self.conv_fused = cfg.conv_impl == "fused"
        self.bf16 = cfg.compute_dtype != "float32"

    def _down(self, ps, x, r):
        """The pyramid input at 1/r: pixel-unshuffle then 1x1, or in bf16 the
        two as one conv (`_ps_down`), as the JAX model does."""
        return _ps_down(ps[1], x, r) if self.bf16 else ps(x)

    def forward(self, x):
        """x: (B, in_chn, H, W), H and W multiples of 8. Global residual."""
        x_l, xh1 = self.down_group1(_conv3x3(self.conv_01, x, self.conv_fused),
                                    self._down(self.ps_down1, x, 2))
        x_l, xh2 = self.down_group2(x_l, self._down(self.ps_down2, x, 4))
        x_l, xh3 = self.down_group3(x_l, self._down(self.ps_down3, x, 8))
        x_l = self.up_group3(x_l, xh3)
        x_l = self.up_group2(x_l, xh2)
        x_l = self.up_group1(x_l, xh1)
        return _conv3x3(self.last, x_l, self.conv_fused) + x


def _ps_down(conv, x, r):
    """PixelUnshuffle(r) then the 1x1 `conv`, as one r x r stride-r conv (the
    JAX package's `_ps_down`, `wavemamba_tpu/models/wavemamba.py:715`): the
    unshuffled channel order is cin * r^2 + dy * r + dx, so the 1x1 weight
    (cout, cin * r^2) is the (cout, cin, r, r) kernel as it lies. The bias is
    added after the conv's rounding, as there."""
    cout, cin = conv.out_channels, x.shape[1]
    kern = conv.weight.to(x.dtype).view(cout, cin, r, r)
    return F.conv2d(x, kern, stride=r) + conv.bias.to(x.dtype).view(1, -1, 1, 1)


class WaveMamba(nn.Module):
    def __init__(self, cfg: WaveMambaConfig = WaveMambaConfig()):
        super().__init__()
        self.cfg = cfg
        self.restoration_network = UNet(cfg)

    def forward(self, x):
        """x: (B, in_chn, H, W) -> the same, in x's dtype; the network runs in
        `cfg.compute_dtype` (the JAX `wavemamba_apply`'s cast in and out)."""
        return self.restoration_network(x.to(DTYPES[self.cfg.compute_dtype])).to(x.dtype)


def set_scan(model: nn.Module, scan) -> None:
    """Route the fused scan of every SS2D of `model` through `scan` (same
    signature as `ss2d_scan_pair`); used to run the plain scan on the card."""
    for m in model.modules():
        if isinstance(m, SS2D):
            m.scan = scan


def set_unfused_scan(model: nn.Module, scan) -> None:
    """Route the unfused scan of every SS2D of `model` (any `scan_impl` but
    'pallas_fused') through `scan(u, delta, A, Bs, Cs, D_skip, delta_bias)`
    instead of the `selective_scan` dispatcher; None restores the dispatcher.
    Used to run the plain scan on the card."""
    for m in model.modules():
        if isinstance(m, SS2D):
            m.unfused_scan = scan


def init_ss2d(m: SS2D, generator, dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4):
    """SS2D's own parameters: x_proj U(+-1/sqrt(d)), dt_projs U(+-r^-0.5), the
    dt bias an inverse softplus so that softplus(bias) is log-uniform in
    [dt_min, dt_max] (floored), A_logs = log(1..N) (S4D-real), Ds = 1."""
    d, n = m.conv2d.in_channels, m.A_logs.shape[1]
    r = m.dt_projs_weight.shape[2]
    _fan_in_uniform(m.x_proj_weight, d, generator)
    _fan_in_uniform(m.dt_projs_weight, r, generator)
    with torch.no_grad():
        unit = torch.empty(4, d, device=generator.device).uniform_(0.0, 1.0, generator=generator)
        dt = torch.exp(unit * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = dt.clamp_min(dt_init_floor)
        m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        m.A_logs.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(4 * d, n))
        m.Ds.fill_(1.0)


def init_wavemamba(model: nn.Module, generator) -> nn.Module:
    """Fill every parameter of `model` from `generator` with the distributions
    of the JAX package's `init_*` (torch's defaults for convolutions and linear
    layers; norms, skip scales and the attention temperature at 1, PReLU 0.25).
    The numbers differ from `jax.random`'s; the distributions do not."""
    for m in model.modules():
        if isinstance(m, SS2D):
            init_ss2d(m, generator)
        elif isinstance(m, nn.Conv2d):
            init_conv2d(m, generator)
        elif isinstance(m, nn.Linear):
            init_linear(m, generator)
        elif isinstance(m, LayerNorm):
            init_layer_norm(m)
        elif isinstance(m, nn.PReLU):
            nn.init.constant_(m.weight, 0.25)
        elif isinstance(m, LFSSBlock):
            nn.init.ones_(m.skip_scale)
            nn.init.ones_(m.skip_scale2)
        elif isinstance(m, CMTAttention):
            nn.init.ones_(m.temperature)
    return model


# x: (B, H, W, in_chn) NHWC, H and W multiples of 8 -> the same, float32;
# differentiable, and without a gradient.
wavemamba_forward, wavemamba_apply = network_forward, network_apply


def pad_to_multiple(x: np.ndarray, multiple=8):
    """Reflect-pad (B, H, W, C) bottom/right to a multiple (`pad_to_shape`);
    returns (padded, h, w)."""
    _, h, w, _ = x.shape
    return pad_to_shape(x, h + (-h) % multiple, w + (-w) % multiple), h, w


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
