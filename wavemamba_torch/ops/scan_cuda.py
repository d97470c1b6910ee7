"""Kernel K1 on the card: the fused SS2D projection + selective scan.

`ss2d_scan_pair` replaces the TPU kernel
`wavemamba_tpu/ops/scan_pallas.py:ss2d_scan_fused` (`_fused_kernel`). Its
CUDA source is `wavemamba_torch/csrc/ss2d_scan.cu`; the note at its top says
what bounds it and how it is laid out. The source is compiled for sm_90a with
`nvcc` at the first launch, into `build/wavemamba_torch/` keyed by a hash of
the source and the compiler flags, and loaded with ctypes. Importing this module needs no `nvcc`.

A CPU tensor takes the plain version (`ops/scan.py:ss2d_scan_pair_plain`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from wavemamba_torch.ops.scan import ss2d_scan_pair_plain

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ss2d_scan.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wavemamba_torch"
D_STATE = 16  # the one state width the kernel is compiled for
MAX_DT_RANK = 4
MAX_D = 128  # 2*D threads per block
CHUNK = 64  # tokens per block of the kernel, and the plain version's chunk on the CPU
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the K1 kernel is built from source")


def build() -> Path:
    """Compile the K1 source into a shared library for sm_90a; returns its path.

    The library is named by the hash of the source and `NVCC_FLAGS`, so an
    unchanged build is made once. `nvcc`'s resource report (`-Xptxas -v`) is kept beside it as
    a `.log` file."""
    digest = hashlib.sha256(SOURCE.read_bytes() + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{SOURCE.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    if not torch.cuda.is_available():
        raise RuntimeError("the K1 kernel needs a CUDA device; torch.cuda.is_available() is False")
    lib = ctypes.CDLL(str(build()))
    fn = lib.ss2d_scan_pair_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_error_string.restype = ctypes.c_char_p
    return lib


def ss2d_scan_pair(x, wx, dtw, bias, A, dsk):
    """Fused projection + scan of one SS2D direction pair.

    x: (B, L, D) token stream; wx: (2, D, R+2N); dtw: (2, R, D); bias, dsk:
    (2, D); A: (2, N, D), negative. Returns y (B, 2, L, D) float32: member 0
    scanned forward, member 1 in reverse, both in token order. Both the
    kernel and the plain version work in chunks of `CHUNK` tokens. Counts
    its kernel launches in `ss2d_scan_pair.launches`.
    """
    if x.device.type == "cpu":
        return ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, chunk=CHUNK)
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan_pair: unsupported device {x.device}")
    b, length, d = x.shape
    r, n = dtw.shape[1], A.shape[1]
    expected = {"x": (x, (b, length, d)), "wx": (wx, (2, d, r + 2 * n)),
                "dtw": (dtw, (2, r, d)), "bias": (bias, (2, d)), "A": (A, (2, n, d)),
                "dsk": (dsk, (2, d))}
    for name, (t, shape) in expected.items():
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ss2d_scan_pair: {name} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ss2d_scan_pair: {name} must be contiguous")
    if n != D_STATE or not 1 <= r <= MAX_DT_RANK or not 1 <= d <= MAX_D:
        raise ValueError(f"ss2d_scan_pair: kernel takes N={D_STATE}, 1<=R<={MAX_DT_RANK}, "
                         f"D<={MAX_D}; got N={n}, R={r}, D={d}")
    if b < 1 or length < 1:
        raise ValueError(f"ss2d_scan_pair: empty input {tuple(x.shape)}")
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
    return y


ss2d_scan_pair.launches = 0
