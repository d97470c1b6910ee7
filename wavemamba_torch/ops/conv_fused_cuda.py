"""The conv-chain kernel on the card (K6 / K7), source `csrc/conv_chain.cu`.

It replaces the TPU kernels `wavemamba_tpu/experimental/conv_fused.py:
_chain_kernel` (`fused_chain`) and `_band_kernel` (`fused_chain_band`), which
compute one function on two tilings; `experimental/conv_fused.py` launches it
from both entry points and counts their launches. The chain is passed as a
descriptor array (`Chain`), which the kernel walks; its 1x1, dense 3x3 and gate
products run on the tensor cores (`mma.sync` bf16). x is float32 or bf16 and y
comes back in x's dtype. The source is built, loaded and launched through
`utils/cxx.py` (built at the first launch, and by `cxx.build_all`);
importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wavemamba_torch.utils import cxx

SOURCE = cxx.CSRC / "conv_chain.cu"
KINDS = ("pw", "dense", "dw", "act", "glu", "mulsig0", "ln", "res0")  # the kernel's enum order
ACTS = ("gelu", "silu", "sigmoid")
MAX_STAGES = 12  # kMaxStages of the source


class Stage(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("cin", ctypes.c_int), ("cout", ctypes.c_int),
                ("act", ctypes.c_int), ("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("eps", ctypes.c_float)]


class Chain(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("halo", ctypes.c_int), ("c0", ctypes.c_int),
                ("cout", ctypes.c_int), ("s", Stage * MAX_STAGES)]


@functools.cache
def _library():
    i, p, out = ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    return cxx.load(SOURCE, {
        "conv_chain": ([p] * 2 + [ctypes.c_longlong] * 4 + [p] + [i] * 6 + [p], i),
        "conv_chain_plan": ([p, i, i, out, out], i)}, "K6 / K7 conv-chain")


def _descriptor(c0, specs) -> Chain:
    """specs: [(kind, cin, cout, act, w, b, eps)] with kind / act names and w, b
    float32 contiguous tensors or None (`conv_fused._specs`)."""
    if not 1 <= len(specs) <= MAX_STAGES:
        raise ValueError(f"a chain has 1 to {MAX_STAGES} stages, got {len(specs)}")
    ch = Chain(n=len(specs), halo=sum(s[0] in ("dense", "dw") for s in specs), c0=c0,
               cout=specs[-1][2])
    for i, (kind, cin, cout, act, w, b, eps) in enumerate(specs):
        ch.s[i] = Stage(KINDS.index(kind), cin, cout, ACTS.index(act) if act else 0,
                        w.data_ptr() if w is not None else None,
                        b.data_ptr() if b is not None else None, eps)
    return ch


def chain_plan(c0, specs, tile_h, tile_w):
    """(core width, shared-memory bytes) the kernel takes for this chain on
    tiles of `tile_h` rows and at most `tile_w` columns: the widest core whose
    buffers and staged weights fit one block an SM."""
    tw, smem = ctypes.c_int(), ctypes.c_int()
    lib = _library()
    err = lib.conv_chain_plan(ctypes.byref(_descriptor(c0, specs)), tile_h, tile_w,
                              ctypes.byref(tw), ctypes.byref(smem))
    if err != 0:
        raise ValueError(f"conv chain: not one column of a {tile_h}-row tile fits shared memory")
    return tw.value, smem.value


def conv_chain(x, specs, tile_h, tile_w):
    """One launch of the chain kernel: x (B, c0, H, W) float32 or bf16 CUDA,
    any strides -> y (B, cout, H, W) contiguous in x's dtype, on tiles of
    `tile_h` rows and the widest width <= `tile_w` that fits shared memory."""
    b, c0, h, w = x.shape
    lib = _library()
    ch = _descriptor(c0, specs)
    y = torch.empty((b, ch.cout, h, w), device=x.device, dtype=x.dtype)
    cxx.launch(lib, "conv_chain", x.device, ctypes.byref(ch), x.data_ptr(), *x.stride(),
               y.data_ptr(), b, h, w, tile_h, tile_w, int(x.dtype == torch.bfloat16))
    return y
