"""Kernels K1-K5 on the card: the fused SS2D projection + selective scan and
its backward (K1, K2), the unfused selective scan over pre-projected inputs
and its backward (K3, K4), and K1's function in the segment-local (SSD) form
(K5).

`ss2d_scan_pair` replaces the TPU kernel
`wavemamba_tpu/ops/scan_pallas.py:ss2d_scan_fused` (`_fused_kernel`), source
`wavemamba_torch/csrc/ss2d_scan.cu`; `ss2d_scan_pair_bwd` replaces
`ss2d_scan_fused_bwd` (`_fused_bwd_kernel`), source `csrc/ss2d_scan_bwd.cu`;
`SS2DScanPair` joins them as the counterpart of the custom VJP
`ss2d_scan_fused_diff`. `selective_scan_cuda` replaces
`scan_pallas.py:selective_scan_pallas` (`_scan_kernel`), source
`csrc/selective_scan.cu`; `selective_scan_cuda_bwd` replaces
`selective_scan_pallas_bwd` (`_scan_bwd_kernel`), source
`csrc/selective_scan_bwd.cu`; `SelectiveScan` joins them as the counterpart of
`wavemamba_tpu/ops/scan.py:_scan_pallas_diff`. `ss2d_scan_pair_ssd` replaces
`ss2d_scan_fused(variant='ssd')` (`_fused_kernel_ssd`), source
`csrc/ss2d_scan_ssd.cu`; it has no backward, as on the TPU. `build_all` also
builds `csrc/conv_chain.cu`, the conv-chain kernel of
`ops/conv_fused_cuda.py` (K6 / K7). The note at the top of each
source says what bounds the kernel and how it is laid out. A source is
compiled for sm_90a with `nvcc` at the first launch, into
`build/wavemamba_torch/` keyed by a hash of the source, the headers beside it
and the compiler flags, and loaded with ctypes. Importing this module needs
no `nvcc`.

A CPU tensor takes the plain versions (`ops/scan.py:ss2d_scan_pair_plain`,
`ss2d_scan_pair_plain_bwd`, `selective_scan_plain`,
`selective_scan_plain_bwd`, and `ss2d_scan_pair_plain(..., variant='ssd')`
for K5); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from wavemamba_torch.ops.scan import (
    selective_scan_plain,
    selective_scan_plain_bwd,
    ss2d_scan_pair_plain,
    ss2d_scan_pair_plain_bwd,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "ss2d_scan.cu"
SOURCE_BWD = CSRC / "ss2d_scan_bwd.cu"
SOURCE_K3 = CSRC / "selective_scan.cu"
SOURCE_K4 = CSRC / "selective_scan_bwd.cu"
SOURCE_K5 = CSRC / "ss2d_scan_ssd.cu"
SOURCE_CHAIN = CSRC / "conv_chain.cu"
SOURCES = (SOURCE, SOURCE_BWD, SOURCE_K3, SOURCE_K4, SOURCE_K5, SOURCE_CHAIN)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wavemamba_torch"
D_STATE = 16  # the one state width the kernels are compiled for
MAX_DT_RANK = 4
MAX_D = 128  # K1: 2*D threads per block
MAX_D_BWD = 64  # K2: its shared-memory tiles are sized for 2*D <= 128 threads
MAX_D_K3 = 256  # K3: D threads per block
MAX_D_K4 = 128  # K4: D threads per block, and a (8, N, D+1) history in shared memory
MAX_STREAMS = 65535  # K3, K4: B*K is a grid's second dimension
CHUNK = 64  # tokens per block of the kernels, and the plain versions' chunk on the CPU
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels are built from source")


def build(source: Path = SOURCE) -> Path:
    """Compile a kernel source into a shared library for sm_90a; returns its path.

    The library is named by the hash of the source, of every header in its
    directory (a source may include any of them) and of `NVCC_FLAGS`, so an
    unchanged build is made once. `nvcc`'s resource report (`-Xptxas -v`) is kept beside it as
    a `.log` file."""
    text = b"\0".join(p.read_bytes() for p in [source, *sorted(source.parent.glob("*.cuh"))])
    digest = hashlib.sha256(text + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> list[Path]:
    """Every library of `SOURCES` (K1-K5, and K6 / K7's), one `nvcc` each,
    started together."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return list(pool.map(build, SOURCES))


def _need_cuda(kernel: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"the {kernel} kernel needs a CUDA device; "
                           "torch.cuda.is_available() is False")


@functools.cache
def _library() -> ctypes.CDLL:
    _need_cuda("K1")
    lib = ctypes.CDLL(str(build(SOURCE)))
    fn = lib.ss2d_scan_pair_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    _need_cuda("K2")
    lib = ctypes.CDLL(str(build(SOURCE_BWD)))
    fn = lib.ss2d_scan_pair_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_k3() -> ctypes.CDLL:
    _need_cuda("K3")
    lib = ctypes.CDLL(str(build(SOURCE_K3)))
    fn = lib.selective_scan_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_k4() -> ctypes.CDLL:
    _need_cuda("K4")
    lib = ctypes.CDLL(str(build(SOURCE_K4)))
    fn = lib.selective_scan_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.selective_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_k5() -> ctypes.CDLL:
    _need_cuda("K5")
    lib = ctypes.CDLL(str(build(SOURCE_K5)))
    fn = lib.ss2d_scan_pair_ssd_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_ssd_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_ssd_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensors(name, x, tensors):
    """Raise unless every tensor is float32, contiguous, of its shape and on
    x's device. tensors: {name: (tensor, shape)}."""
    for key, (t, shape) in tensors.items():
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_inputs(name, x, tensors, max_d):
    """Raise on what K1 / K2 do not take. tensors: {name: (tensor, shape)}."""
    _check_tensors(name, x, tensors)
    b, length, d = x.shape
    r, n = tensors["dtw"][1][1], tensors["A"][1][1]
    if n != D_STATE or not 1 <= r <= MAX_DT_RANK or not 1 <= d <= max_d:
        raise ValueError(f"{name}: kernel takes N={D_STATE}, 1<=R<={MAX_DT_RANK}, "
                         f"D<={max_d}; got N={n}, R={r}, D={d}")
    if b < 1 or length < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def _pair_shapes(x, wx, dtw, bias, A, dsk):
    b, length, d = x.shape
    r, n = dtw.shape[1], A.shape[1]
    return {"x": (x, (b, length, d)), "wx": (wx, (2, d, r + 2 * n)),
            "dtw": (dtw, (2, r, d)), "bias": (bias, (2, d)), "A": (A, (2, n, d)),
            "dsk": (dsk, (2, d))}


def _launch_k1(x, wx, dtw, bias, A, dsk):
    """K1 on CUDA tensors: y, and the scratch it leaves behind, `state`
    (B, 2, nc, N, D), the state entering each chunk, and `sumda` (B, 2, nc, D),
    each chunk's sum of da: what K2 needs."""
    _check_inputs("ss2d_scan_pair", x, _pair_shapes(x, wx, dtw, bias, A, dsk), MAX_D)
    b, length, d = x.shape
    r, n = dtw.shape[1], A.shape[1]
    lib = _library()
    nc = -(-length // CHUNK)
    y = torch.empty((b, 2, length, d), device=x.device, dtype=torch.float32)
    state = torch.empty((b, 2, nc, n, d), device=x.device, dtype=torch.float32)
    sumda = torch.empty((b, 2, nc, d), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ss2d_scan_pair_f32(
            x.data_ptr(), wx.data_ptr(), dtw.data_ptr(), bias.data_ptr(), A.data_ptr(),
            dsk.data_ptr(), y.data_ptr(), state.data_ptr(), sumda.data_ptr(),
            b, length, d, n, r, CHUNK, stream)
    if err != 0:
        raise RuntimeError(f"ss2d_scan_pair launch failed: {lib.ss2d_scan_error_string(err).decode()}")
    ss2d_scan_pair.launches += 1
    return y, state, sumda


def _forward(x, wx, dtw, bias, A, dsk):
    """(y, state, sumda) on either device."""
    if x.device.type == "cpu":
        return ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, chunk=CHUNK, return_carries=True)
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan_pair: unsupported device {x.device}")
    return _launch_k1(x, wx, dtw, bias, A, dsk)


def ss2d_scan_pair(x, wx, dtw, bias, A, dsk, return_carries=False, variant="twopass", sub=8):
    """Fused projection + scan of one SS2D direction pair.

    x: (B, L, D) token stream; wx: (2, D, R+2N); dtw: (2, R, D); bias, dsk:
    (2, D); A: (2, N, D), negative. Returns y (B, 2, L, D) float32: member 0
    scanned forward, member 1 in reverse, both in token order. Both the
    kernel and the plain version work in chunks of `CHUNK` tokens. With
    `return_carries` also the chunk-entry states (B, 2, nc, N, D) and the
    chunks' sums of da (B, 2, nc, D), detached. Differentiable: when an input
    requires grad the call goes through `SS2DScanPair`, whose backward is K2.
    Counts its kernel launches in `ss2d_scan_pair.launches`.

    variant='ssd' computes the same function by K5 (`ss2d_scan_pair_ssd`),
    segments of `sub` tokens; 'twopass' is K1.
    """
    args = (x, wx, dtw, bias, A, dsk)
    if variant == "ssd":
        return ss2d_scan_pair_ssd(*args, sub=sub, return_carries=return_carries)
    if variant != "twopass":
        raise ValueError(f"unknown variant {variant!r}; known: 'twopass', 'ssd'")
    if return_carries:
        return _forward(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SS2DScanPair.apply(*args)
    return _forward(*args)[0]


ss2d_scan_pair.launches = 0


def ss2d_scan_pair_ssd(x, wx, dtw, bias, A, dsk, sub=8, return_carries=False):
    """K1's function by kernel K5, the segment-local (SSD) factorization in
    segments of `sub` tokens (dividing `CHUNK`). Arguments, y and carries as
    `ss2d_scan_pair`'s. f32 bounds the form: max |A| times the sum of da over a
    segment must stay below ~88. No backward, as on the TPU: a call that would
    need one raises. Counts its kernel launches in `ss2d_scan_pair_ssd.launches`.
    """
    args = (x, wx, dtw, bias, A, dsk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError("ss2d_scan_pair_ssd (K5) has no backward; the TPU kernel has "
                                  "none either. Use variant='twopass' (K1 + K2) to train")
    if not 1 <= sub <= CHUNK or CHUNK % sub:
        raise ValueError(f"ss2d_scan_pair_ssd: sub={sub} must divide {CHUNK}")
    if x.device.type == "cpu":
        out = ss2d_scan_pair_plain(*args, chunk=CHUNK, return_carries=True, variant="ssd", sub=sub)
        return out if return_carries else out[0]
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan_pair_ssd: unsupported device {x.device}")
    _check_inputs("ss2d_scan_pair_ssd", x, _pair_shapes(*args), MAX_D)
    b, length, d = x.shape
    r, n = dtw.shape[1], A.shape[1]
    lib = _library_k5()
    nc = -(-length // CHUNK)
    y = torch.empty((b, 2, length, d), device=x.device, dtype=torch.float32)
    state = torch.empty((b, 2, nc, n, d), device=x.device, dtype=torch.float32)
    sumda = torch.empty((b, 2, nc, d), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ss2d_scan_pair_ssd_f32(
            x.data_ptr(), wx.data_ptr(), dtw.data_ptr(), bias.data_ptr(), A.data_ptr(),
            dsk.data_ptr(), y.data_ptr(), state.data_ptr(), sumda.data_ptr(),
            b, length, d, n, r, CHUNK, sub, stream)
    if err != 0:
        raise RuntimeError("ss2d_scan_pair_ssd launch failed: "
                           f"{lib.ss2d_scan_ssd_error_string(err).decode()}")
    ss2d_scan_pair_ssd.launches += 1
    return (y, state, sumda) if return_carries else y


ss2d_scan_pair_ssd.launches = 0


def ss2d_scan_pair_bwd(x, wx, dtw, bias, A, dsk, state, sumda, dy):
    """Backward of `ss2d_scan_pair` (kernel K2).

    `state`, `sumda`: what the forward returns with `return_carries`; dy:
    (B, 2, L, D). Returns (dx, dwx, ddtw, dbias, dA, ddsk), dx (B, L, D) summed
    over the pair and the rest in the layouts of wx, dtw, bias, A and dsk.
    The sums over tokens and batch are taken in a fixed order: the same bits
    every run. Counts its kernel launches in `ss2d_scan_pair_bwd.launches`.
    """
    if x.device.type == "cpu":
        return ss2d_scan_pair_plain_bwd(x, wx, dtw, bias, A, dsk, state, dy, chunk=CHUNK)
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan_pair_bwd: unsupported device {x.device}")
    b, length, d = x.shape
    r, n = dtw.shape[1], A.shape[1]
    nc = -(-length // CHUNK)
    shapes = _pair_shapes(x, wx, dtw, bias, A, dsk)
    shapes.update(state=(state, (b, 2, nc, n, d)), sumda=(sumda, (b, 2, nc, d)),
                  dy=(dy, (b, 2, length, d)))
    _check_inputs("ss2d_scan_pair_bwd", x, shapes, MAX_D_BWD)
    lib = _library_bwd()
    j = r + 2 * n
    rows = j + r + 1 + n + 1  # dwx | ddtw | dbias | dA | ddsk
    # Blocks that share a batch element's chunks: two waves of one block per SM.
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    gx = min(nc, max(1, -(-2 * sms // b)))
    dx = torch.empty_like(x)
    gcar = torch.empty_like(state)
    part = torch.empty((b * gx, rows, 2, d), device=x.device, dtype=torch.float32)
    sums = torch.empty((rows, 2, d), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ss2d_scan_pair_bwd_f32(
            x.data_ptr(), wx.data_ptr(), dtw.data_ptr(), bias.data_ptr(), A.data_ptr(),
            dsk.data_ptr(), state.data_ptr(), sumda.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), gcar.data_ptr(), part.data_ptr(), sums.data_ptr(),
            b, length, d, n, r, CHUNK, gx, stream)
    if err != 0:
        raise RuntimeError("ss2d_scan_pair_bwd launch failed: "
                           f"{lib.ss2d_scan_bwd_error_string(err).decode()}")
    ss2d_scan_pair_bwd.launches += 1
    return (dx, sums[:j].permute(1, 2, 0).contiguous(),
            sums[j:j + r].transpose(0, 1).contiguous(), sums[j + r],
            sums[j + r + 1:j + r + 1 + n].transpose(0, 1).contiguous(), sums[j + r + 1 + n])


ss2d_scan_pair_bwd.launches = 0


class SS2DScanPair(torch.autograd.Function):
    """`ss2d_scan_pair` with K2 as its backward: the forward keeps the inputs,
    the chunk-entry states and the chunk decays; nothing else is saved."""

    @staticmethod
    def forward(ctx, x, wx, dtw, bias, A, dsk):
        y, state, sumda = _forward(x, wx, dtw, bias, A, dsk)
        ctx.save_for_backward(x, wx, dtw, bias, A, dsk, state, sumda)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ss2d_scan_pair_bwd(*ctx.saved_tensors, dy.contiguous())


def _scan_shapes(u, delta, A, Bs, Cs, D_skip, delta_bias):
    b, k, length, d = u.shape
    n = A.shape[-1]
    return {"u": (u, (b, k, length, d)), "delta": (delta, (b, k, length, d)),
            "A": (A, (k, d, n)), "Bs": (Bs, (b, k, length, n)), "Cs": (Cs, (b, k, length, n)),
            "D_skip": (D_skip, (k, d)), "delta_bias": (delta_bias, (k, d))}


def _check_scan_inputs(name, u, tensors, max_d):
    """Raise on what K3 / K4 do not take."""
    if len(u.shape) != 4:
        raise ValueError(f"{name}: u must be (B, K, L, D), got {tuple(u.shape)}")
    _check_tensors(name, u, tensors)
    b, k, length, d = u.shape
    n = tensors["A"][1][2]
    if n != D_STATE or not 1 <= d <= max_d or b * k > MAX_STREAMS:
        raise ValueError(f"{name}: kernel takes N={D_STATE}, D<={max_d}, B*K<={MAX_STREAMS}; "
                         f"got N={n}, D={d}, B*K={b * k}")
    if b < 1 or k < 1 or length < 1:
        raise ValueError(f"{name}: empty input {tuple(u.shape)}")


def _launch_k3(u, delta, A, Bs, Cs, D_skip, delta_bias):
    """K3 on CUDA tensors: y, and the scratch it leaves behind for K4, `state`
    (B, K, nc, N, D), the state entering each chunk, and `sumda` (B, K, nc, D),
    each chunk's sum of da."""
    args = (u, delta, A, Bs, Cs, D_skip, delta_bias)
    _check_scan_inputs("selective_scan_cuda", u, _scan_shapes(*args), MAX_D_K3)
    b, k, length, d = u.shape
    n = A.shape[-1]
    lib = _library_k3()
    nc = -(-length // CHUNK)
    y = torch.empty_like(u)
    state = torch.empty((b, k, nc, n, d), device=u.device, dtype=torch.float32)
    sumda = torch.empty((b, k, nc, d), device=u.device, dtype=torch.float32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_fwd_f32(
            *(t.data_ptr() for t in args), y.data_ptr(), state.data_ptr(), sumda.data_ptr(),
            b, k, length, d, n, CHUNK, stream)
    if err != 0:
        raise RuntimeError("selective_scan_cuda launch failed: "
                           f"{lib.selective_scan_error_string(err).decode()}")
    selective_scan_cuda.launches += 1
    return y, state, sumda


def _scan_forward(*args):
    """(y, state, sumda) on either device."""
    u = args[0]
    if u.device.type == "cpu":
        return selective_scan_plain(*args, chunk=CHUNK, return_carries=True)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_cuda: unsupported device {u.device}")
    return _launch_k3(*args)


def selective_scan_cuda(u, delta, A, Bs, Cs, D_skip, delta_bias, return_carries=False):
    """The selective scan over pre-projected inputs (kernel K3).

    u, delta: (B, K, L, D); A: (K, D, N), negative; Bs, Cs: (B, K, L, N);
    D_skip, delta_bias: (K, D). Returns y (B, K, L, D) float32. Both the
    kernel and the plain version work in chunks of `CHUNK` tokens. With
    `return_carries` also the chunk-entry states (B, K, nc, N, D) and the
    chunks' sums of da (B, K, nc, D), detached. Differentiable: when an input
    requires grad the call goes through `SelectiveScan`, whose backward is K4.
    Counts its kernel launches in `selective_scan_cuda.launches`.
    """
    args = (u, delta, A, Bs, Cs, D_skip, delta_bias)
    if return_carries:
        return _scan_forward(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SelectiveScan.apply(*args)
    return _scan_forward(*args)[0]


selective_scan_cuda.launches = 0


def selective_scan_cuda_bwd(u, delta, A, Bs, Cs, D_skip, delta_bias, state, sumda, dy):
    """Backward of `selective_scan_cuda` (kernel K4).

    `state`, `sumda`: what the forward returns with `return_carries`; dy:
    (B, K, L, D). Returns (du, ddelta, dA, dBs, dCs, dD_skip, ddelta_bias) in
    the inputs' layouts, ddelta before the softplus. The sums over tokens and
    batch are taken in a fixed order: the same bits every run. Counts its
    kernel launches in `selective_scan_cuda_bwd.launches`.
    """
    args = (u, delta, A, Bs, Cs, D_skip, delta_bias)
    if u.device.type == "cpu":
        return selective_scan_plain_bwd(*args, state, dy, chunk=CHUNK)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_cuda_bwd: unsupported device {u.device}")
    shapes = _scan_shapes(*args)
    b, k, length, d = u.shape
    n = A.shape[-1]
    nc = -(-length // CHUNK)
    shapes.update(state=(state, (b, k, nc, n, d)), sumda=(sumda, (b, k, nc, d)),
                  dy=(dy, (b, k, length, d)))
    _check_scan_inputs("selective_scan_cuda_bwd", u, shapes, MAX_D_K4)
    lib = _library_k4()
    # Blocks that share a stream's chunks: about six blocks per SM in all.
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    gx = min(nc, max(1, -(-6 * sms // (b * k))))
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bs), torch.empty_like(Cs)
    gcar = torch.empty_like(state)
    part = torch.empty((b * k, gx, n + 2, d), device=u.device, dtype=torch.float32)
    sums = torch.empty((k, n + 2, d), device=u.device, dtype=torch.float32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_bwd_f32(
            *(t.data_ptr() for t in args), state.data_ptr(), sumda.data_ptr(), dy.data_ptr(),
            du.data_ptr(), ddelta.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            gcar.data_ptr(), part.data_ptr(), sums.data_ptr(),
            b, k, length, d, n, CHUNK, gx, stream)
    if err != 0:
        raise RuntimeError("selective_scan_cuda_bwd launch failed: "
                           f"{lib.selective_scan_bwd_error_string(err).decode()}")
    selective_scan_cuda_bwd.launches += 1
    return (du, ddelta, sums[:, :n].transpose(1, 2).contiguous(), dB, dC,
            sums[:, n], sums[:, n + 1])


selective_scan_cuda_bwd.launches = 0


class SelectiveScan(torch.autograd.Function):
    """`selective_scan_cuda` with K4 as its backward: the forward keeps the
    inputs, the chunk-entry states and the chunks' sums of da; nothing
    L x N x D sized is saved."""

    @staticmethod
    def forward(ctx, u, delta, A, Bs, Cs, D_skip, delta_bias):
        y, state, sumda = _scan_forward(u, delta, A, Bs, Cs, D_skip, delta_bias)
        ctx.save_for_backward(u, delta, A, Bs, Cs, D_skip, delta_bias, state, sumda)
        return y

    @staticmethod
    def backward(ctx, dy):
        return selective_scan_cuda_bwd(*ctx.saved_tensors, dy.contiguous())
