"""ART's attention without a gradient, source `csrc/art_attention.cu`.

For each group b (of `rows`, or all) and head h:

    out[b, i, h*hd:(h+1)*hd] = softmax_j(q[b,h,i] . k[b,h,j]
                                         + table[idx(i, j), h] + key_bias[j]) v[b,h,j]

with `table` the bias MLP's output over a gh x gw grid's offsets
((2gh-1)(2gw-1), heads) and idx(i, j) = lin(i) - lin(j) + C, the offset
between query token i and key token j (`offset_index`). The output is laid
out (B, N, heads * hd), as `Attention.proj` reads it.

It replaces no TPU kernel (the JAX package computes ART's attention with XLA
einsums); it takes the place of torch's memory-efficient attention on ART's
no-gradient route, which read the bias as a dense (heads, N, N) mask. The
note at the top of the source says what bounds it and how it is laid out.

`art_attention` takes the plain version (`art_attention_plain`) for a CPU
tensor and launches the kernel for a CUDA one, or raises: float32, head
width 32, the grid's table and keys within a block's shared memory
(`fits`). Its launches are counted in `art_attention.launches`. The source is
built by `scan_cuda.build` at the first launch; importing this module needs
no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wavemamba_torch.ops.scan_cuda import CSRC, _need_cuda, build

SOURCE = CSRC / "art_attention.cu"
HEAD_DIM = 32  # the one head width the kernel is built for
SMEM_MAX = 232_448  # a block's shared memory on an H100 (kSmemMax of the source)
PLAIN_SCORE_BYTES = 1 << 28  # the plain version builds the scores this many bytes at a time


def offset_index(gh: int, gw: int) -> np.ndarray:
    """(N, N) int64: the row of the bias table for query token i and key
    token j of a gh x gw grid, lin(i) - lin(j) + C, lin(t) = y(t) (2gw-1) +
    x(t), C = (gh-1)(2gw-1) + gw-1 (what the kernel computes)."""
    t = np.arange(gh * gw)
    lin = (t // gw) * (2 * gw - 1) + t % gw
    return lin[:, None] - lin[None, :] + (gh - 1) * (2 * gw - 1) + gw - 1


def smem_bytes(gh: int, gw: int) -> int:
    """A block's dynamic shared memory for a gh x gw grid (`smem_bytes` of
    the source): the alignment slack, four 8 KB tiles (N <= 64) or a ring of
    two sets of them and its barriers, the table's column and lin(k) of the
    keys padded to 64."""
    n = gh * gw
    tiles = 4 * 8192 if n <= 64 else 2 * 4 * 8192 + 64
    return 1024 + tiles + 4 * (2 * gh - 1) * (2 * gw - 1) + 4 * (-(-n // 64) * 64)


def fits(gh: int, gw: int) -> bool:
    """Whether the kernel takes a gh x gw grid (2,040 tokens at a 4K bucket's
    sparse groups take 107 KB; the limit is about 8,000 tokens)."""
    return smem_bytes(gh, gw) <= SMEM_MAX


def art_attention_plain(q, k, v, table, gh, gw, key_bias=None, rows=None, out=None):
    """The kernel's function in plain PyTorch: the bias gathered from
    `table` by `offset_index`, the scores built for a chunk of groups at a
    time (`PLAIN_SCORE_BYTES`). q, k, v (B, heads, N, hd),
    q already scaled; table (offsets, heads); key_bias (N,) or None; rows a
    1-D integer tensor of groups or None (all); out (B, N, heads * hd) or
    None (allocated). Returns out."""
    b, heads, n, hd = q.shape
    if out is None:
        out = q.new_empty(b, n, heads * hd)
    rows = torch.arange(b, device=q.device) if rows is None else rows.long()
    bias = table.t()[:, torch.from_numpy(offset_index(gh, gw)).to(q.device)]
    if key_bias is not None:
        bias = bias + key_bias
    step = max(1, PLAIN_SCORE_BYTES // (4 * heads * n * n))  # groups a chunk
    for part in rows.split(step):
        s = q[part] @ k[part].transpose(-2, -1) + bias
        out[part] = (s.softmax(-1) @ v[part]).transpose(1, 2).reshape(-1, n, heads * hd)
    return out


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v")]
                + [(f"{t}_s{d}", ctypes.c_longlong) for t in "qkv" for d in "bhn"]
                + [("table", ctypes.c_void_p), ("t_so", ctypes.c_longlong),
                   ("t_sh", ctypes.c_longlong), ("key_bias", ctypes.c_void_p),
                   ("rows", ctypes.c_void_p), ("out", ctypes.c_void_p),
                   ("o_sb", ctypes.c_longlong), ("o_sn", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("B", "H", "N", "gh", "gw")])


@functools.cache
def _library() -> ctypes.CDLL:
    _need_cuda("ART attention")
    lib = ctypes.CDLL(str(build(SOURCE)))
    lib.art_attention.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.art_attention.restype = ctypes.c_int
    lib.art_attention_smem.argtypes = [ctypes.c_int] * 3
    lib.art_attention_smem.restype = ctypes.c_longlong
    lib.art_attention_error_string.argtypes = [ctypes.c_int]
    lib.art_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, table, gh, gw, key_bias, rows, out):
    b, heads, n, hd = q.shape
    tensors = {"q": q, "k": k, "v": v, "table": table, "out": out}
    if key_bias is not None:
        tensors["key_bias"] = key_bias
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"ART attention: {name} must be float32 on {q.device}, "
                             f"got {t.dtype} on {t.device}")
    if hd != HEAD_DIM or n != gh * gw or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ART attention takes q, k, v (B, heads, {gh}x{gw}, {HEAD_DIM}), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if table.shape != ((2 * gh - 1) * (2 * gw - 1), heads):
        raise ValueError(f"ART attention: the table is (offsets, heads), got {tuple(table.shape)}")
    if out.shape != (b, n, heads * hd) or out.stride(2) != 1 or out.stride(0) % 2 or \
            out.stride(1) % 2 or out.data_ptr() % 8:
        raise ValueError(f"ART attention: out must be ({b}, {n}, {heads * hd}) with unit "
                         f"stride last and even strides, got {tuple(out.shape)} {out.stride()}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"ART attention: {name} needs a unit stride over the head width")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"ART attention: {name} is read 16 bytes at a time: "
                             f"strides {t.stride()}")
    if key_bias is not None and (key_bias.shape != (n,) or key_bias.stride(0) != 1):
        raise ValueError(f"ART attention: key_bias must be ({n},) contiguous")
    if rows is not None and (rows.device != q.device or rows.dtype != torch.int32 or
                             rows.dim() != 1 or not rows.is_contiguous()):
        raise ValueError("ART attention: rows must be a contiguous int32 vector on q's device")
    if not fits(gh, gw):
        raise ValueError(f"ART attention: a {gh}x{gw} grid's bias table and keys take "
                         f"{smem_bytes(gh, gw)} bytes of shared memory, over {SMEM_MAX}")


def art_attention(q, k, v, table, gh, gw, key_bias=None, rows=None, out=None):
    """`art_attention_plain`'s function; on CUDA one launch of the kernel.
    q, k, v are read through their strides (a unit stride over the head
    width). Returns out, (B, N, heads * hd)."""
    if not q.is_cuda:
        return art_attention_plain(q, k, v, table, gh, gw, key_bias, rows, out)
    b, heads, n, hd = q.shape
    if out is None:
        out = q.new_empty(b, n, heads * hd)
    _check(q, k, v, table, gh, gw, key_bias, rows, out)
    groups = b if rows is None else rows.numel()
    if groups == 0:
        return out
    lib = _library()
    p = _Params(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                table.data_ptr(), *table.stride(),
                key_bias.data_ptr() if key_bias is not None else None,
                rows.data_ptr() if rows is not None else None,
                out.data_ptr(), out.stride(0), out.stride(1),
                groups, heads, n, gh, gw)
    with torch.cuda.device(q.device):
        err = lib.art_attention(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ART attention launch failed: "
                           f"{lib.art_attention_error_string(err).decode()}")
    art_attention.launches += 1
    return out


art_attention.launches = 0
