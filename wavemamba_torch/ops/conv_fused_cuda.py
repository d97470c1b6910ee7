"""The conv-chain kernel on the card (K6 / K7), source `csrc/conv_chain.cu`.

It replaces the TPU kernels `wavemamba_tpu/experimental/conv_fused.py:
_chain_kernel` (`fused_chain`) and `_band_kernel` (`fused_chain_band`), which
compute one function on two tilings; `experimental/conv_fused.py` launches it
from both entry points and counts their launches. The chain is passed as a
descriptor array (`Chain`), which the kernel walks. The source is built like
the scan kernels', by `scan_cuda.build` at the first launch (and by
`scan_cuda.build_all`); importing this module needs no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from wavemamba_torch.ops.scan_cuda import SOURCE_CHAIN, _need_cuda, build

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
def _library() -> ctypes.CDLL:
    _need_cuda("K6 / K7 conv-chain")
    lib = ctypes.CDLL(str(build(SOURCE_CHAIN)))
    lib.conv_chain_f32.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
                                   + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.conv_chain_f32.restype = ctypes.c_int
    lib.conv_chain_plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.conv_chain_plan.restype = ctypes.c_int
    lib.conv_chain_error_string.argtypes = [ctypes.c_int]
    lib.conv_chain_error_string.restype = ctypes.c_char_p
    return lib


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
    tiles of `tile_h` rows and at most `tile_w` columns."""
    tw, smem = ctypes.c_int(), ctypes.c_int()
    lib = _library()
    err = lib.conv_chain_plan(ctypes.byref(_descriptor(c0, specs)), tile_h, tile_w,
                              ctypes.byref(tw), ctypes.byref(smem))
    if err != 0:
        raise ValueError(f"conv chain: not one column of a {tile_h}-row tile fits shared memory")
    return tw.value, smem.value


def conv_chain(x, specs, tile_h, tile_w):
    """One launch of the chain kernel: x (B, c0, H, W) float32 CUDA, any
    strides -> y (B, cout, H, W) contiguous, on tiles of `tile_h` rows and the
    widest width <= `tile_w` that fits shared memory."""
    b, c0, h, w = x.shape
    lib = _library()
    ch = _descriptor(c0, specs)
    y = torch.empty((b, ch.cout, h, w), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv_chain_f32(ctypes.byref(ch), x.data_ptr(), *x.stride(), y.data_ptr(),
                                 b, h, w, tile_h, tile_w, stream)
    if err != 0:
        raise RuntimeError(f"conv chain launch failed: {lib.conv_chain_error_string(err).decode()}")
    return y
