"""Fused conv chains: a chain of convolution stages in one kernel launch.

The counterpart of `wavemamba_tpu/experimental/conv_fused.py`, reached only
through `WaveMambaConfig(conv_impl='fused')`, for inference. Activations are
NCHW, the modules' own layout; weights are the modules' parameters as they
are (PyTorch layouts).

Chain DSL (a tuple of stages, walked in order):
    ("pw",      w (Co, Cin[, 1, 1]), b | None)   1x1 conv, bf16 operands
    ("dense",   w (Co, Cin, 3, 3),   b | None)   dense 3x3, bf16 operands
    ("dw",      w (C, 1, 3, 3),      b | None)   depthwise 3x3, float32
    ("act",     name)                            'gelu' (tanh form) | 'silu' | 'sigmoid'
    ("glu",     name)                            y = act(y[:C/2]) * y[C/2:]
    ("mulsig0", w (Co, Cin[, 1, 1]), b | None)   y *= sigmoid(x0 . w + b), x0 the chain input
    ("ln",      g, b, eps)                       LayerNorm over channels, f32 statistics
    ("res0",    scale | None)                    y += [scale *] x0
A bf16 operand is the float32 value rounded to nearest even; the sums are
float32 (the plain version takes each exactly and rounds once, `_product`).
The GELU is the tanh form of the TPU kernel (`conv_fused.py:70-75`), not the
exact erf of the stock route. x is float32 or bf16, as in the JAX
package: it is widened to float32, every stage runs in float32 (the TPU
kernel's working dtype) and the output is rounded once into x's dtype;
mulsig0 and res0 read the chain input as it came.

`fused_chain_plain` is the chain in plain PyTorch over the whole image, SAME
zero padding for each 3x3 stage. `fused_chain` (TPU kernel K6, 2-D tiles) and
`fused_chain_band` (K7, row bands) are the entry points: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel of
`ops/conv_fused_cuda.py` (one source for both) or raises. Each counts its
launches in `.launches`. The chains have no backward (as the TPU's have no
VJP): a call with grad mode on and an input or weight that requires grad
raises. `_run` sends the nine wrappers to the band kernel by default, as the
JAX package does; `band_h=None`, or a call inside `chain_route("tile")`, takes
K6, and inside `chain_route("plain")` they run the plain version on any device
(to hold the kernels against it on the card). Inside `chain_route("op")` they
reach the same kernel through the registered op `wavemamba_torch::conv_chain`
(`conv_chain_op`), which `torch.export` keeps as one node: the deployment
artifact's route (`wavemamba_torch/deploy.py`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from wavemamba_torch.ops.conv_fused_cuda import ACTS, KINDS, conv_chain
from wavemamba_torch.ops.nn import layer_norm

ROUTES = ("band", "tile", "plain", "op")
_ROUTE = ["band"]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _act(name, v):
    if name == "gelu":
        return F.gelu(v, approximate="tanh")
    if name == "silu":
        return F.silu(v)
    if name == "sigmoid":
        return torch.sigmoid(v)
    raise ValueError(f"unknown activation {name!r}")


def _specs(c0, stages):
    """Check a chain against its input's channel count: [(kind, cin, cout, act,
    w, b, eps)], the weights flattened to their kernel layouts."""
    specs, c = [], c0
    for stage in stages:
        kind = stage[0]
        if kind in ("act", "glu"):
            if stage[1] not in ACTS:
                raise ValueError(f"unknown activation {stage[1]!r}; known: {ACTS}")
            if kind == "glu" and c % 2:
                raise ValueError(f"glu on an odd channel count {c}")
            specs.append((kind, c, c // 2 if kind == "glu" else c, stage[1], None, None, 0.0))
            c = specs[-1][2]
        elif kind == "ln":
            g, b, eps = stage[1], stage[2], float(stage[3])
            if g.numel() != c or b.numel() != c:
                raise ValueError(f"ln over {c} channels, got {g.numel()} / {b.numel()}")
            specs.append((kind, c, c, None, g.reshape(-1), b.reshape(-1), eps))
        elif kind == "res0":
            s = stage[1]
            if c != c0 or (s is not None and s.numel() != c0):
                raise ValueError(f"res0 adds the {c0}-channel input to {c} channels")
            specs.append((kind, c, c, None, None if s is None else s.reshape(-1), None, 0.0))
        elif kind in ("pw", "dense", "dw", "mulsig0"):
            w, b = stage[1], stage[2]
            cin = c0 if kind == "mulsig0" else c
            shape = {"pw": (w.shape[0], cin), "mulsig0": (c, cin), "dense": (w.shape[0], cin, 3, 3),
                     "dw": (c, 1, 3, 3)}[kind]
            if w.numel() != math.prod(shape) or w.shape[0] != shape[0]:
                raise ValueError(f"{kind} weight {tuple(w.shape)} does not fit {shape}")
            if b is not None and b.numel() != shape[0]:
                raise ValueError(f"{kind} bias {tuple(b.shape)} for {shape[0]} channels")
            cout = shape[0]
            specs.append((kind, cin, cout, None, w.reshape(shape), None if b is None else b.reshape(-1),
                          0.0))
            c = c if kind == "mulsig0" else cout
        else:
            raise ValueError(f"unknown stage {kind!r}")
    return specs


def _product(a, w, b, padding=0):
    """A product stage: a and w rounded to bf16, the sum of their products
    taken exactly (float64 holds every bf16 product and their sums here) and
    rounded once to float32, then the bias added in float32. That is the value
    a float32 accumulation approaches whatever its order; a particular order's
    own rounding (cuDNN's) flips a later bf16 rounding (paconv_chain's second
    3x3) on more outputs than the kernels' check allows, and the kernels on
    the tensor cores cannot share that order."""
    y = F.conv2d(_bf16(a).double(), _bf16(w).double(), padding=padding).float()
    return y if b is None else y + b.view(1, -1, 1, 1)


def fused_chain_plain(x, stages):
    """The chain over the whole image in plain PyTorch (the plain version of
    K6 and K7): x (B, C, H, W) float32 or bf16 -> (B, Cout, H, W) in x's
    dtype, computed in float32 (each product's sum exactly, `_product`)."""
    return _plain(x, _specs(x.shape[1], stages))


def _plain(x, specs):
    x0 = x.float()
    cur = x0
    for kind, cin, cout, act, w, b, eps in specs:
        if kind == "pw":
            cur = _product(cur, w.view(cout, cin, 1, 1), b)
        elif kind == "dense":
            cur = _product(cur, w, b, padding=1)
        elif kind == "dw":
            cur = F.conv2d(cur, w, b, padding=1, groups=cin)
        elif kind == "act":
            cur = _act(act, cur)
        elif kind == "glu":
            cur = _act(act, cur[:, :cout]) * cur[:, cout:]
        elif kind == "mulsig0":
            cur = cur * torch.sigmoid(_product(x0, w.view(cout, cin, 1, 1), b))
        elif kind == "ln":
            cur = layer_norm(cur, w, b, eps, dim=1)
        else:  # res0
            cur = cur + (x0 if w is None else x0 * w.view(1, -1, 1, 1))
    return cur.to(x.dtype)


def _check(name, x, stages):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: {x.dtype} input; the chains take float32 or bfloat16")
    tensors = [x] + [t for s in stages for t in s[1:] if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the fused conv chains are inference only, with no backward "
                           "(the JAX package's have no VJP): call under torch.no_grad(), or use "
                           "conv_impl='xla' to train")


def _launch(name, x, specs, tile_h, tile_w):
    """One launch of the chain kernel on a CUDA tensor; any other device raises."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for s in specs:
        for t in s[4:6]:
            if t is not None and (t.device != x.device or t.dtype != torch.float32
                                  or not t.is_contiguous()):
                raise ValueError(f"{name}: {s[0]} weights must be float32, contiguous, on {x.device}")
    return conv_chain(x, specs, tile_h, tile_w)


def fused_chain(x, stages, tile_h=8, tile_w=128):
    """The chain on 2-D tiles (kernel K6): x (B, C, H, W) float32 or bf16 ->
    (B, Cout, H, W) in x's dtype. The kernel takes `tile_h` rows and, of `tile_w`
    columns, as many as its shared memory holds."""
    _check("fused_chain", x, stages)
    if x.device.type == "cpu":
        return fused_chain_plain(x, stages)
    y = _launch("fused_chain", x, _specs(x.shape[1], stages), tile_h, tile_w)
    fused_chain.launches += 1
    return y


fused_chain.launches = 0


def fused_chain_band(x, stages, band_h=16):
    """The chain on row bands of `band_h` rows (kernel K7): the same function
    as `fused_chain`. A band is cut into as wide tiles as shared memory holds."""
    _check("fused_chain_band", x, stages)
    if x.device.type == "cpu":
        return fused_chain_plain(x, stages)
    y = _launch("fused_chain_band", x, _specs(x.shape[1], stages), band_h, x.shape[3])
    fused_chain_band.launches += 1
    return y


fused_chain_band.launches = 0


@torch.library.custom_op("wavemamba_torch::conv_chain", mutates_args=())
def conv_chain_op(x: torch.Tensor, weights: list[Optional[torch.Tensor]], kinds: list[int],
                  cin: list[int], cout: list[int], act: list[int], eps: list[float], tile_h: int,
                  tile_w: int, band: bool) -> torch.Tensor:
    """K7 (`band`: row bands of `tile_h` rows, as `fused_chain_band`) or K6
    (2-D tiles, as `fused_chain`) as a registered op, so that `torch.export`
    keeps a chain as one node whose weights are the program's inputs: the
    chain of `_specs` as tensor and number lists (`_op_args`), each stage's
    (w, b) in `weights`, its kind and activation as indices into
    `conv_fused_cuda.KINDS` / `ACTS` (-1: none). The kernel's descriptor is
    built here from the weights' addresses, which a FakeTensor lacks. On a
    CPU tensor the plain version; counts each launch as its entry point does."""
    specs = [(KINDS[k], ci, co, None if a < 0 else ACTS[a], weights[2 * i], weights[2 * i + 1], e)
             for i, (k, ci, co, a, e) in enumerate(zip(kinds, cin, cout, act, eps))]
    if x.device.type == "cpu":
        return _plain(x, specs)
    entry = fused_chain_band if band else fused_chain
    y = _launch(entry.__name__, x, specs, tile_h, tile_w)
    entry.launches += 1
    return y


@conv_chain_op.register_fake
def _conv_chain_fake(x, weights, kinds, cin, cout, act, eps, tile_h, tile_w, band):
    return x.new_empty((x.shape[0], cout[-1], x.shape[2], x.shape[3]))


def _op_args(x, stages):
    """`conv_chain_op`'s weights and number lists for `stages` on x."""
    specs = _specs(x.shape[1], stages)
    return ([t for s in specs for t in s[4:6]], [KINDS.index(s[0]) for s in specs],
            [s[1] for s in specs], [s[2] for s in specs],
            [-1 if s[3] is None else ACTS.index(s[3]) for s in specs], [s[6] for s in specs])


@contextlib.contextmanager
def chain_route(route):
    """Inside, every wrapper below takes `route`: 'tile' the 2-D tile kernel
    (K6), as with band_h=None, 'plain' the plain version on any device, 'op'
    the kernel the default picks (K7, or K6 with band_h=None) through the
    registered op `conv_chain_op` (the deployment artifact's route), 'band'
    the default. The model calls the wrappers with their defaults: this is how
    K6, the op, and the plain chains on the card, run through it."""
    if route not in ROUTES:
        raise ValueError(f"unknown chain route {route!r}; known: {ROUTES}")
    before = _ROUTE[0]
    _ROUTE[0] = route
    try:
        yield
    finally:
        _ROUTE[0] = before


# --------------------------------------------------------------------------
# Model-level chain wrappers: the modules of `models/wavemamba.py` as they are.


def _run(x, stages, tile_h, tile_w, band_h):
    """Row-band kernel by default; band_h=None (or `chain_route('tile')`) the
    2-D tiles; `chain_route('plain')` the plain version; `chain_route('op')`
    the default's kernel through `conv_chain_op`."""
    if _ROUTE[0] == "plain":
        _check("fused_chain_plain", x, stages)
        return fused_chain_plain(x, stages)
    if _ROUTE[0] == "op":
        _check("conv_chain_op", x, stages)
        band = band_h is not None
        return conv_chain_op(x, *_op_args(x, stages), band_h if band else tile_h,
                             x.shape[3] if band else tile_w, band)
    if band_h is not None and _ROUTE[0] == "band":
        return fused_chain_band(x, stages, band_h=band_h)
    return fused_chain(x, stages, tile_h=tile_h, tile_w=tile_w)


def _ln_prefix(ln):
    """A `LayerNorm` module folded in front of a chain (None: nothing)."""
    return () if ln is None else (("ln", ln.weight, ln.bias, ln.eps),)


def ffn_chain(m, x, tile_h=8, tile_w=128, band_h=16):
    """LFSS ffn (`FFN`): 1x1 -> dw3x3 -> SimpleGate(gelu) -> 1x1."""
    return _run(x, (
        ("pw", m.conv1.weight, m.conv1.bias),
        ("dw", m.conv2.weight, m.conv2.bias),
        ("glu", "gelu"),
        ("pw", m.conv3.weight, m.conv3.bias),
    ), tile_h, tile_w, band_h)


def lfss_ffn_block(ln, ffn, skip_scale, x, band_h=16):
    """LFSS second half-block in one chain: x * skip_scale + ffn(ln(x))."""
    return _run(x, _ln_prefix(ln) + (
        ("pw", ffn.conv1.weight, ffn.conv1.bias),
        ("dw", ffn.conv2.weight, ffn.conv2.bias),
        ("glu", "gelu"),
        ("pw", ffn.conv3.weight, ffn.conv3.bias),
        ("res0", skip_scale),
    ), 8, 128, band_h)


def qkv_chain(m, x, tile_h=8, tile_w=128, band_h=16, ln=None):
    """CMT qkv (`CMTAttention`): [LN ->] 1x1 (C -> 3C) -> dw3x3."""
    return _run(x, _ln_prefix(ln) + (
        ("pw", m.qkv.weight, m.qkv.bias),
        ("dw", m.qkv_dwconv.weight, m.qkv_dwconv.bias),
    ), tile_h, tile_w, band_h)


def paconv_chain(m, x, tile_h=8, tile_w=128, band_h=16):
    """PAConv: k4(k3(x) * sigmoid(k2(x)))."""
    return _run(x, (
        ("dense", m.k3.weight, None),
        ("mulsig0", m.k2.weight, m.k2.bias),
        ("dense", m.k4.weight, None),
    ), tile_h, tile_w, band_h)


def ff_in_chain(seq, x, tile_h=8, tile_w=128, band_h=16, ln=None):
    """HFE FeedForward project_in (`nn.Sequential(1x1, dw3x3)`): [LN ->] 1x1 -> dw3x3."""
    return _run(x, _ln_prefix(ln) + (
        ("pw", seq[0].weight, seq[0].bias),
        ("dw", seq[1].weight, seq[1].bias),
    ), tile_h, tile_w, band_h)


def ff_out_chain(seq, x, tile_h=8, tile_w=128, band_h=16):
    """HFE FeedForward project_out (`nn.Sequential(dw3x3, GELU, 1x1)`): dw3x3 ->
    gelu (tanh form) -> 1x1."""
    return _run(x, (
        ("dw", seq[0].weight, seq[0].bias),
        ("act", "gelu"),
        ("pw", seq[2].weight, seq[2].bias),
    ), tile_h, tile_w, band_h)


def restormer_chain(m, x, tile_h=8, tile_w=128, band_h=16, ln=None, residual=False):
    """FeedForwardRestormer: [LN ->] 1x1 -> dw3x3 -> GLU(gelu) -> 1x1 [-> + x];
    residual=True adds the chain input back (the HFE block residual)."""
    stages = _ln_prefix(ln) + (
        ("pw", m.project_in.weight, m.project_in.bias),
        ("dw", m.dwconv.weight, m.dwconv.bias),
        ("glu", "gelu"),
        ("pw", m.project_out.weight, m.project_out.bias),
    )
    if residual:
        stages = stages + (("res0", None),)
    return _run(x, stages, tile_h, tile_w, band_h)


def dw_act(conv, x, act="silu", tile_h=8, tile_w=128, band_h=16):
    """Depthwise 3x3 + activation (SS2D's conv2d + silu)."""
    return _run(x, (("dw", conv.weight, conv.bias), ("act", act)), tile_h, tile_w, band_h)


def dense3x3(conv, x, tile_h=8, tile_w=128, band_h=16):
    """A single dense 3x3 (l_conv, h_out_conv, conv_01, last)."""
    return _run(x, (("dense", conv.weight, conv.bias),), tile_h, tile_w, band_h)
