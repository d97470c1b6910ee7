"""Kernels K1-K5 on the card: the fused SS2D projection + selective scan and
its backward (K1, K2), the unfused selective scan over pre-projected inputs
and its backward (K3, K4), and K1's function in the segment-local (SSD) form
(K5).

`ss2d_scan_pair` replaces the TPU kernel
`wavemamba_tpu/ops/scan_pallas.py:ss2d_scan_fused` (`_fused_kernel`), source
`wavemamba_torch/csrc/ss2d_scan.cu`; `ss2d_scan_pair_bwd` replaces
`ss2d_scan_fused_bwd` (`_fused_bwd_kernel`), source `csrc/ss2d_scan_bwd.cu`;
the registered op `ss2d_scan_pair_fwd` joins them as the counterpart of the
custom VJP `ss2d_scan_fused_diff`. `selective_scan_cuda` replaces
`scan_pallas.py:selective_scan_pallas` (`_scan_kernel`), source
`csrc/selective_scan.cu`; `selective_scan_cuda_bwd` replaces
`selective_scan_pallas_bwd` (`_scan_bwd_kernel`), source
`csrc/selective_scan_bwd.cu`; `SelectiveScan` joins them as the counterpart of
`wavemamba_tpu/ops/scan.py:_scan_pallas_diff`. `ss2d_scan_pair_ssd` replaces
`ss2d_scan_fused(variant='ssd')` (`_fused_kernel_ssd`), source
`csrc/ss2d_scan_ssd.cu` (K1's layout, whose staging and chunk prefix it
shares through `csrc/ss2d_scan_common.cuh`); it has no backward, as on the
TPU. `build_all` also
builds `csrc/conv_chain.cu`, the conv-chain kernel of
`ops/conv_fused_cuda.py` (K6 / K7), and `csrc/gpu_probe.cu`, the probes of
`scripts/gpu_probe.py` (P1-P5). The note at the top of each
source says what bounds the kernel and how it is laid out. `k1_plan` ...
`k5_plan` give K1-K5's launch geometry from shapes alone (K3: a quad of
threads per channel, 256-thread blocks over a chunk, a stream and 64
channels, and a prefix with a worker for every 8 chunks; K5: K1's), and
`k1_occupancy` ... `k5_occupancy` what the card lets reside. A source is
compiled for sm_90a with `nvcc` at the first launch, into
`build/wavemamba_torch/` keyed by a hash of the source, the headers beside it
and the compiler flags, and loaded with ctypes. Importing this module needs
no `nvcc`.

A CPU tensor takes the plain versions (`ops/scan.py:ss2d_scan_pair_plain`,
`ss2d_scan_pair_plain_bwd`, `selective_scan_plain`,
`selective_scan_plain_bwd`, and `ss2d_scan_pair_plain(..., variant='ssd')`
for K5); a CUDA tensor launches the kernel or raises.

K1, K2 and K5 take bf16 token streams in three pairs (`STREAM_PAIRS`): x and
y (K2: x and dx, and dy) all float32, all bf16 (the bf16 presets), or bf16 x
with float32 y / dy (`compute_dtype: bfloat16` with the default `scan_dtype:
float32`, as the proc and proc512 ymls train). float32 x with bf16 y / dy is
refused on the card (on the CPU the plain versions take any mix). y is
rounded once from float32, dx once per member and once for the pair's sum,
in x's dtype, as the TPU kernel's; the weights and all arithmetic stay
float32.
K3 and K4 take bf16 streams by widening them to float32 before the launch,
as the JAX wrapper does before its `pallas_call`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

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
SOURCE_PROBE = CSRC / "gpu_probe.cu"
SOURCES = (SOURCE, SOURCE_BWD, SOURCE_K3, SOURCE_K4, SOURCE_K5, SOURCE_CHAIN, SOURCE_PROBE)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wavemamba_torch"
D_STATE = 16  # the one state width the kernels are compiled for
MAX_DT_RANK = 4
MAX_D = 128  # K1: a block scans 64 channels, two blocks a chunk above 64
MAX_D_BWD = 64  # K2: a block holds 2 x 64 channels, four threads each
MAX_D_K3 = 256  # K3: a block scans 64 channels, a quad of threads each; up to four groups
MAX_D_K4 = 128  # K4: a block holds 64 channels (D <= 64) or 128, a quad of threads each
MAX_STREAMS = 65535  # K3, K4: B*K is a grid's second dimension
CHUNK = 64  # tokens per block of the kernels, and the plain versions' chunk on the CPU
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_SECONDS: dict[str, float] = {}  # source name -> seconds of its nvcc run in this process


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
    a `.log` file, and the seconds `nvcc` took in `BUILD_SECONDS`."""
    text = b"\0".join(p.read_bytes() for p in [source, *sorted(source.parent.glob("*.cuh"))])
    digest = hashlib.sha256(text + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[source.name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> list[Path]:
    """Every library of `SOURCES` (K1-K5, K6 / K7's and the probes P1-P5 of
    `scripts/gpu_probe.py`), one `nvcc` each, started together."""
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
    fn = lib.ss2d_scan_pair
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_occupancy.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.ss2d_scan_occupancy.restype = ctypes.c_int
    lib.ss2d_scan_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    _need_cuda("K2")
    lib = ctypes.CDLL(str(build(SOURCE_BWD)))
    fn = lib.ss2d_scan_pair_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_bwd_occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.ss2d_scan_bwd_occupancy.restype = ctypes.c_int
    lib.ss2d_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_k3() -> ctypes.CDLL:
    _need_cuda("K3")
    lib = ctypes.CDLL(str(build(SOURCE_K3)))
    fn = lib.selective_scan_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.selective_scan_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.selective_scan_occupancy.restype = ctypes.c_int
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
    lib.selective_scan_bwd_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.selective_scan_bwd_occupancy.restype = ctypes.c_int
    lib.selective_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_k5() -> ctypes.CDLL:
    _need_cuda("K5")
    lib = ctypes.CDLL(str(build(SOURCE_K5)))
    fn = lib.ss2d_scan_pair_ssd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ss2d_scan_ssd_occupancy.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.ss2d_scan_ssd_occupancy.restype = ctypes.c_int
    lib.ss2d_scan_ssd_error_string.argtypes = [ctypes.c_int]
    lib.ss2d_scan_ssd_error_string.restype = ctypes.c_char_p
    return lib


STREAM_DTYPES = (torch.float32, torch.bfloat16)  # of K1's, K2's and K5's x, y, dy and dx
# The (x, y) pairs K1 and K5 are built for, and the (x, dy) pairs K2 is: both float32,
# both bf16, and bf16 x with float32 y / dy.
STREAM_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32))


def _stream_flags(name, x_dtype, other, other_dtype):
    """(x is bf16, `other` is bf16) for the C entry, or raise on the one pair
    of stream dtypes the kernels are not built for: float32 x with a bf16
    `other` (y or dy), which no preset or yml asks for."""
    if (x_dtype, other_dtype) not in STREAM_PAIRS:
        raise NotImplementedError(
            f"{name}: the kernel is not built for float32 x with bfloat16 {other}; it takes "
            "x and {0} both float32, both bfloat16, or bfloat16 x with float32 {0}".format(other))
    return int(x_dtype == torch.bfloat16), int(other_dtype == torch.bfloat16)


def _check_tensors(name, x, tensors, streams=()):
    """Raise unless every tensor is float32 (or, for the keys in `streams`,
    bf16), contiguous, of its shape and on x's device. tensors: {name:
    (tensor, shape)}."""
    for key, (t, shape) in tensors.items():
        dtypes = STREAM_DTYPES if key in streams else (torch.float32,)
        if t.device != x.device or t.dtype not in dtypes or tuple(t.shape) != shape:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name}: {key} must be {names} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_inputs(name, x, tensors, max_d, streams=()):
    """Raise on what K1 / K2 / K5 do not take. tensors: {name: (tensor, shape)}."""
    _check_tensors(name, x, tensors, streams)
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


@functools.cache
def _sm_count(index):
    """The SMs of CUDA device `index` (None: the current device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on_device(device):
    """A context that makes `device` current, or none where it is already
    (switching costs the host some microseconds a launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch_pair(name, library, plan_of, x, wx, dtw, bias, A, dsk, out_dtype, *sub):
    """K1 (or, with `sub`, K5) on CUDA tensors: y in `out_dtype`, and what it
    leaves behind for K2, `state` (B, 2, nc, N, D), the state entering each
    chunk, and `sumda` (B, 2, nc, D), each chunk's sum of da. `library`
    loads the kernel's source, whose C entry is named `name`; the launch
    takes the shared memory of `plan_of` (`k1_plan` or `k5_plan`; the source
    refuses any other) and its x_dbl scratch."""
    _check_inputs(name, x, _pair_shapes(x, wx, dtw, bias, A, dsk), MAX_D, ("x",))
    if out_dtype not in STREAM_DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    x_bf16, y_bf16 = _stream_flags(name, x.dtype, "y", out_dtype)
    b, length, d = x.shape
    r, n = dtw.shape[1], A.shape[1]
    lib = library()
    plan = plan_of(b, length, d, n, r, CHUNK, *sub, _sm_count(x.device.index))
    # The kernel reads x and wx 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied.
    x, wx = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, wx))
    nc = -(-length // CHUNK)
    y = torch.empty((b, 2, length, d), device=x.device, dtype=out_dtype)
    state = torch.empty((b, 2, nc, n, d), device=x.device, dtype=torch.float32)
    sumda = torch.empty((b, 2, nc, d), device=x.device, dtype=torch.float32)
    xdbl = torch.empty(plan["xdbl_shape"], device=x.device, dtype=torch.float32)
    with _on_device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            x.data_ptr(), wx.data_ptr(), dtw.data_ptr(), bias.data_ptr(), A.data_ptr(),
            dsk.data_ptr(), y.data_ptr(), state.data_ptr(), sumda.data_ptr(), xdbl.data_ptr(),
            b, length, d, n, r, CHUNK, *sub, plan["smem_scan"], x_bf16, y_bf16, stream)
    if err != 0:
        message = getattr(lib, name.replace("_pair", "") + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {message}")
    return y, state, sumda


def _forward(x, wx, dtw, bias, A, dsk, out_dtype=None):
    """(y, state, sumda) on either device."""
    if x.device.type == "cpu":
        return ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, chunk=CHUNK, return_carries=True,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan_pair: unsupported device {x.device}")
    y, state, sumda = _launch_pair("ss2d_scan_pair", _library, k1_plan, x, wx, dtw, bias, A, dsk,
                                   out_dtype or torch.float32)
    ss2d_scan_pair.launches += 1
    return y, state, sumda


def x_digest(x):
    """A digest of x's bits: the int64 sum of x read as integers of its
    width. Equal bits give equal digests."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float64: torch.int64}[x.dtype]
    return x.view(ints).sum(dtype=torch.int64)


class XDigests:
    """What `record_x_digests` collects: for each op that a 'save_scan'
    recompute answers from its forward's outputs, the pair (digest of the x
    the forward scanned, digest of the x the recompute handed it). K2 reads
    the recompute's x beside the forward's carries, so the two must be the
    same bits."""

    def __init__(self):
        self.pairs = []

    def matched(self) -> int:
        """The pairs whose digests are equal (reads them from the device)."""
        return sum(int(a) == int(b) for a, b in self.pairs)


# The record that `record_x_digests` has on, or None (the default: no digest
# is taken). Not per thread: the recompute runs on autograd's thread.
_x_record: Optional[XDigests] = None


@contextlib.contextmanager
def record_x_digests():
    """Within the block, each 'save_scan' op digests its x in the forward and
    again in the recompute's replay (`x_digest`, one small reduction each);
    yields the `XDigests` that collects the pairs."""
    global _x_record
    outer, _x_record = _x_record, XDigests()
    try:
        yield _x_record
    finally:
        _x_record = outer


class _ScanStash:
    """The outputs of `ss2d_scan_pair_fwd` in one checkpointed block: kept in
    order by its forward, handed back in that order by each recompute. Under
    `record_x_digests` also the digest of each forward's x, paired with the
    replay's."""

    def __init__(self):
        self.outputs, self.replaying, self.taken, self.x_digests = [], False, 0, {}

    def take(self, compute, x=None):
        if not self.replaying:
            out = compute()
            # Aliases, so that autograd's history on the returned tensors is not theirs.
            self.outputs.append(tuple(t.detach() for t in out))
            if _x_record is not None and x is not None:
                self.x_digests[len(self.outputs) - 1] = x_digest(x)
            return out
        if self.taken == len(self.outputs):
            raise RuntimeError(f"save_scan: the recompute ran the scan op more often than the "
                               f"forward ({len(self.outputs)} times)")
        out = self.outputs[self.taken]
        if _x_record is not None and self.taken in self.x_digests:
            _x_record.pairs.append((self.x_digests[self.taken], x_digest(x)))
        self.taken += 1
        return tuple(t.detach() for t in out)


class _StashScope:
    """Makes `stash` the one `ss2d_scan_pair_fwd` answers from on this thread,
    recording (the forward) or replaying from the first (a recompute)."""

    def __init__(self, stash, replaying):
        self.stash, self.replaying = stash, replaying

    def __enter__(self):
        self.outer = getattr(_active_stash, "stash", None)
        self.stash.replaying, self.stash.taken = self.replaying, 0
        _active_stash.stash = self.stash

    def __exit__(self, *exc):
        _active_stash.stash = self.outer


# The stash of the checkpointed block being run. The op is reached from inside
# the block, where no argument can carry it; per thread, as the recompute runs
# on autograd's.
_active_stash = threading.local()


def save_scan_contexts():
    """`context_fn` of `torch.utils.checkpoint.checkpoint` (non-reentrant) for
    the 'save_scan' recompute policy: K1's outputs (y, the chunk-entry states
    and the chunks' sums of da) are kept from the block's forward and the
    recompute hands them back, so K1 runs once a step; every other op of the
    block is recomputed as under 'full', with no per-op dispatch."""
    stash = _ScanStash()
    return _StashScope(stash, replaying=False), _StashScope(stash, replaying=True)


@torch.library.custom_op("wavemamba_torch::ss2d_scan_pair_fwd", mutates_args=())
def ss2d_scan_pair_fwd(x: torch.Tensor, wx: torch.Tensor, dtw: torch.Tensor, bias: torch.Tensor,
                       A: torch.Tensor, dsk: torch.Tensor, out_dtype: Optional[torch.dtype] = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as a registered op, with K2 as its backward: (y, state, sumda) of
    `ss2d_scan_pair(..., return_carries=True)`, by the kernel on a CUDA tensor
    and the plain version on a CPU one. y is differentiable; state and sumda,
    what K2 reads, are not. Inside a block checkpointed under 'save_scan'
    (`save_scan_contexts`) the forward keeps its three outputs and the
    block's recompute takes them back, in order, without a launch."""
    stash = getattr(_active_stash, "stash", None)
    if stash is None:
        return _forward(x, wx, dtw, bias, A, dsk, out_dtype)
    return stash.take(lambda: _forward(x, wx, dtw, bias, A, dsk, out_dtype), x)


def _setup_fwd_context(ctx, inputs, output):
    x, wx, dtw, bias, A, dsk, _ = inputs
    _, state, sumda = output
    ctx.save_for_backward(x, wx, dtw, bias, A, dsk, state, sumda)
    ctx.mark_non_differentiable(state, sumda)
    ctx.set_materialize_grads(False)  # no zero tensors for the carries' absent gradients


def _fwd_backward(ctx, dy, _dstate, _dsumda):
    """K2: the gradients in each input's dtype (dx in x's, the weights' float32);
    none where y has none."""
    if dy is None:
        return (None,) * 7
    return ss2d_scan_pair_bwd(*ctx.saved_tensors, dy.contiguous()) + (None,)


torch.library.register_autograd("wavemamba_torch::ss2d_scan_pair_fwd", _fwd_backward,
                                setup_context=_setup_fwd_context)


@torch.library.register_fake("wavemamba_torch::ss2d_scan_pair_fwd")
def _fwd_fake(x, wx, dtw, bias, A, dsk, out_dtype=None):
    """The op's outputs as `_launch_pair` allocates them, without data: what
    `torch.export` traces the op by."""
    b, length, d = x.shape
    n, nc = A.shape[1], -(-length // CHUNK)
    return (x.new_empty((b, 2, length, d), dtype=out_dtype or torch.float32),
            x.new_empty((b, 2, nc, n, d), dtype=torch.float32),
            x.new_empty((b, 2, nc, d), dtype=torch.float32))


def ss2d_scan_pair_op(x, wx, dtw, bias, A, dsk, return_carries=False, variant="twopass", sub=8,
                      out_dtype=None):
    """`ss2d_scan_pair` that always goes through the registered op
    `ss2d_scan_pair_fwd`, with or without autograd, so that `torch.export`
    keeps K1 as one op node (the deployment artifact's route,
    `wavemamba_torch/deploy.py`, installs it with `models.wavemamba.set_scan`).
    The op runs K1 on a CUDA tensor and the plain version on a CPU one, so
    one traced program runs on both devices. K1 only: variant='ssd' raises."""
    if variant != "twopass":
        raise ValueError(f"ss2d_scan_pair_op runs K1 only (variant='twopass'), got {variant!r}")
    out = ss2d_scan_pair_fwd(x, wx, dtw, bias, A, dsk, out_dtype)
    return out if return_carries else out[0]


def ss2d_scan_pair(x, wx, dtw, bias, A, dsk, return_carries=False, variant="twopass", sub=8,
                   out_dtype=None):
    """Fused projection + scan of one SS2D direction pair.

    x: (B, L, D) token stream, float32 or bf16; wx: (2, D, R+2N); dtw: (2, R,
    D); bias, dsk: (2, D); A: (2, N, D), negative; the weights float32.
    Returns y (B, 2, L, D), float32 or `out_dtype` (float32 or bf16; on the
    card (x, y) is one of `STREAM_PAIRS`): member 0 scanned forward, member 1
    in reverse, both in token order. Both the kernel and the plain version
    work in chunks of `CHUNK` tokens. With
    `return_carries` also the chunk-entry states (B, 2, nc, N, D) and the
    chunks' sums of da (B, 2, nc, D), detached. Differentiable: when an input
    requires grad the call goes through the op `ss2d_scan_pair_fwd`, whose
    backward is K2. Counts its kernel launches in `ss2d_scan_pair.launches`:
    a call that a 'save_scan' recompute answers from the forward's outputs
    (`save_scan_contexts`) launches nothing and counts nothing.

    variant='ssd' computes the same function by K5 (`ss2d_scan_pair_ssd`),
    segments of `sub` tokens; 'twopass' is K1.
    """
    args = (x, wx, dtw, bias, A, dsk)
    if variant == "ssd":
        return ss2d_scan_pair_ssd(*args, sub=sub, return_carries=return_carries,
                                  out_dtype=out_dtype)
    if variant != "twopass":
        raise ValueError(f"unknown variant {variant!r}; known: 'twopass', 'ssd'")
    if return_carries:
        return _forward(*args, out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return ss2d_scan_pair_fwd(*args, out_dtype)[0]
    return _forward(*args, out_dtype)[0]


ss2d_scan_pair.launches = 0


def ss2d_scan_pair_ssd(x, wx, dtw, bias, A, dsk, sub=8, return_carries=False, out_dtype=None):
    """K1's function by kernel K5, the segment-local (SSD) factorization in
    segments of `sub` tokens (dividing `CHUNK`). Arguments, y (in `out_dtype`),
    carries and the stream pairs the card takes as `ss2d_scan_pair`'s. f32
    bounds the form: max |A| times the sum of da over a segment must stay
    below ~88. No backward, as on the TPU: a call that would need one raises.
    The launch takes `k5_plan`'s shared memory (the source refuses any other)
    and its x_dbl scratch. Counts its kernel launches in
    `ss2d_scan_pair_ssd.launches`.
    """
    args = (x, wx, dtw, bias, A, dsk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError("ss2d_scan_pair_ssd (K5) has no backward; the TPU kernel has "
                                  "none either. Use variant='twopass' (K1 + K2) to train")
    if not 1 <= sub <= CHUNK or CHUNK % sub:
        raise ValueError(f"ss2d_scan_pair_ssd: sub={sub} must divide {CHUNK}")
    if x.device.type == "cpu":
        out = ss2d_scan_pair_plain(*args, chunk=CHUNK, return_carries=True, variant="ssd", sub=sub,
                                   out_dtype=out_dtype)
        return out if return_carries else out[0]
    if x.device.type != "cuda":
        raise ValueError(f"ss2d_scan_pair_ssd: unsupported device {x.device}")
    out = _launch_pair("ss2d_scan_pair_ssd", _library_k5, k5_plan, *args, out_dtype or torch.float32,
                       sub)
    ss2d_scan_pair_ssd.launches += 1
    return out if return_carries else out[0]


ss2d_scan_pair_ssd.launches = 0


K2_THREADS = 2 * MAX_D_BWD * 4  # a quad of threads per (direction, channel)
SMEM_PER_SM = 233_472  # an H100 SM's shared memory: 228 KB
SMEM_RESERVED = 1_024  # the runtime's share of each resident block
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32
K1_GROUP = 64  # channels a chunk_scan block scans
K1_THREADS = 2 * K1_GROUP * 2  # both directions, a quad of threads per channel pair
K1_PREFIX_LANES, K1_PREFIX_WORKERS = 16, 64  # chunk_prefix: (n, d) lanes x workers a block
# The resident blocks an SM each kernel's launch bounds ask for: its register
# budget a thread is 65,536 over threads x blocks. K5's chunk_scan_ssd as K1's
# chunk_scan; both run the same chunk_prefix.
K1_SCAN_BLOCKS, K1_PREFIX_BLOCKS = 3, 1
K5_SCAN_BLOCKS = 3


def _resident(threads, smem):
    """Blocks an SM holds by its 2,048 threads, 32 blocks and 228 KB of shared
    memory."""
    return min(THREADS_PER_SM // threads, BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))


def _scan_plan(threads, smem_scan, scan_blocks, grid_scan, prefix_threads, prefix_blocks,
               grid_prefix, sms):
    """What K1's and K3's plans share: pass 1 and the replay on `threads` a
    block and `smem_scan` bytes of dynamic shared memory, the chunk prefix on
    `prefix_threads` a block and its two static arrays, sized for
    K1_PREFIX_LANES x K1_PREFIX_WORKERS. For each, the blocks and warps an SM
    that shared memory, 2,048 threads, 32 blocks and the kernel's launch
    bounds (`scan_blocks`, `prefix_blocks`) let reside, and the scan's blocks
    against what `sms` SMs hold at once (`waves_scan`)."""
    smem_prefix = 4 * 2 * K1_PREFIX_LANES * K1_PREFIX_WORKERS
    scan = min(_resident(threads, smem_scan), scan_blocks)
    prefix = min(_resident(prefix_threads, smem_prefix), prefix_blocks)
    return {"threads": threads, "smem_scan": smem_scan, "blocks_per_sm_scan": scan,
            "warps_per_sm_scan": scan * -(-threads // 32), "grid_scan": grid_scan,
            "waves_scan": math.prod(grid_scan) / (sms * scan),
            "prefix_threads": prefix_threads, "smem_prefix": smem_prefix,
            "blocks_per_sm_prefix": prefix, "warps_per_sm_prefix": prefix * -(-prefix_threads // 32),
            "grid_prefix": grid_prefix}


def k1_plan(B, L, D, N, R, T, sms):
    """K1's launch geometry, from shapes alone (the kernel's source,
    `csrc/ss2d_scan.cu`, sizes its tiles by the same sums, and refuses a
    launch whose shared memory is not this plan's).

    chunk_scan (pass 1 and the replay) runs `threads` a block on a grid of
    (chunks, B, channel groups of 64); its dynamic shared memory `smem_scan`
    holds the x tile and wx rows of width 64 * groups + 4, x_dbl of both
    directions, and da. chunk_prefix runs `prefix_threads` a block, one block
    per K1_PREFIX_LANES (n, d) lanes of each (direction, batch element), on
    static shared memory `smem_prefix`. For each, the blocks and warps an SM that shared
    memory, 2,048 threads and the register budget of the kernel's launch
    bounds let reside (the registers used are the card's to report:
    `k1_occupancy`), and chunk_scan's blocks against what `sms` SMs hold at
    once (`waves_scan`). `xdbl_shape` is the scratch where pass 1 leaves x_dbl
    for the replay."""
    return _pair_plan("K1", B, L, D, N, R, T, sms, K1_SCAN_BLOCKS)


def _pair_plan(kernel, B, L, D, N, R, T, sms, scan_blocks):
    """`k1_plan` for K1's or K5's source (`kernel`), whose scan blocks
    `scan_blocks` reside on an SM by their launch bounds."""
    name = f"{kernel.lower()}_plan"
    if N != D_STATE or not 1 <= R <= MAX_DT_RANK or not 1 <= D <= MAX_D:
        raise ValueError(f"{name}: {kernel} takes N={D_STATE}, 1<=R<={MAX_DT_RANK}, D<={MAX_D}; "
                         f"got N={N}, R={R}, D={D}")
    if not 4 <= T <= 64 or T % 4:
        raise ValueError(f"{name}: {kernel} takes chunks of T <= 64 tokens, a multiple of 4; "
                         f"got T={T}")
    groups = -(-D // K1_GROUP)
    width, J, JP = K1_GROUP * groups + 4, R + 2 * N, 4 + 2 * N
    smem_scan = 4 * (T * width + 2 * T * JP + max(2 * J * width, 2 * T * K1_GROUP))
    plan = _scan_plan(K1_THREADS, smem_scan, scan_blocks, (-(-L // T), B, groups),
                      K1_PREFIX_LANES * K1_PREFIX_WORKERS, K1_PREFIX_BLOCKS,
                      (-(-N * D // K1_PREFIX_LANES), 2, B), sms)
    return {**plan, "xdbl_shape": (B, 2, L, JP)}


def k1_occupancy(D=64, R=2, streams=STREAM_PAIRS[0], T=CHUNK):
    """What the card reports for K1's kernels (N = 16) on the (x, y) dtypes
    `streams` at the launch's threads and shared memory: {threads, smem_scan,
    blocks_per_sm_pass1, blocks_per_sm_replay, prefix_threads,
    blocks_per_sm_prefix} from `cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
    registers included."""
    return _pair_occupancy("k1_occupancy", _library, "ss2d_scan", D, R, streams, T)


def _pair_occupancy(name, library, prefix, D, R, streams, T):
    """`k1_occupancy` from K1's or K5's library, whose C functions are named
    from `prefix` (`ss2d_scan`, `ss2d_scan_ssd`)."""
    flags = _stream_flags(name, streams[0], "y", streams[1])
    lib = library()
    out = (ctypes.c_int * 6)()
    err = getattr(lib, f"{prefix}_occupancy")(D_STATE, R, D, T, *flags, out)
    if err != 0:
        message = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{prefix}_occupancy failed: {message}")
    keys = ("threads", "smem_scan", "blocks_per_sm_pass1", "blocks_per_sm_replay",
            "prefix_threads", "blocks_per_sm_prefix")
    return dict(zip(keys, out))


def k5_plan(B, L, D, N, R, T, S, sms):
    """K5's launch geometry, from shapes alone: K1's (`k1_plan`; the source,
    `csrc/ss2d_scan_ssd.cu`, shares K1's tiles and chunk prefix and refuses a
    launch whose shared memory is not this plan's), and `sub`, the segment of
    S tokens, which divides the chunk of T."""
    if not 1 <= S <= T or T % S:
        raise ValueError(f"k5_plan: sub={S} must divide the chunk of T={T} tokens")
    return {**_pair_plan("K5", B, L, D, N, R, T, sms, K5_SCAN_BLOCKS), "sub": S}


def k5_occupancy(D=64, R=2, streams=STREAM_PAIRS[0], T=CHUNK):
    """What the card reports for K5's kernels (N = 16) on the (x, y) dtypes
    `streams`, with the keys of `k1_occupancy`."""
    return _pair_occupancy("k5_occupancy", _library_k5, "ss2d_scan_ssd", D, R, streams, T)


def k2_plan(B, L, D, N, R, T, sms):
    """K2's launch geometry, from shapes alone (the kernel's source,
    `csrc/ss2d_scan_bwd.cu`, sizes its tiles by the same sums).

    Returns threads a block (both kernels), the dynamic shared memory of
    `bwd_local` and `bwd_main` in bytes, the blocks and warps of each that the
    SM's shared memory and 2,048 threads let reside (registers are the card's
    to report: `k2_occupancy`), and `gx`, the blocks of `bwd_main`, which
    stride over all B * ceil(L / T) chunks: as many as reside at once on `sms`
    SMs, one whole wave. Tiles hold 64 channels whatever D <= 64 is."""
    if not 1 <= D <= MAX_D_BWD:
        raise ValueError(f"k2_plan: K2 takes 1 <= D <= {MAX_D_BWD}, got D={D}")
    J, JP, DP, DM, S = R + 2 * N, 4 + 2 * N, MAX_D_BWD + 1, MAX_D_BWD, 8
    smem_local = 4 * (2 * T * JP + max(2 * DM * J + T * DP, 2 * T * DM) + 2 * T * DM)
    smem_main = 4 * (2 * DM * J + 2 * T * JP + 2 * T * DP + (T // S) * 2 * DM * N + 4 * T * DM
                     + 2 * (DM // 8) * S * J + 2 * S * J + 4 * S * DM)

    local, main = _resident(K2_THREADS, smem_local), _resident(K2_THREADS, smem_main)
    return {"threads": K2_THREADS, "smem_local": smem_local, "smem_main": smem_main,
            "blocks_per_sm_local": local, "blocks_per_sm_main": main,
            "warps_per_sm_local": local * K2_THREADS // 32,
            "warps_per_sm_main": main * K2_THREADS // 32,
            "gx": max(1, min(B * -(-L // T), sms * main))}


def k2_occupancy(R=2, streams=STREAM_PAIRS[0], T=CHUNK):
    """What the card reports for K2's kernels (N = 16) on the (x, dy) dtypes
    `streams` at the launch's threads and shared memory: {threads,
    smem_local, smem_main, blocks_per_sm_local, blocks_per_sm_main} from
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`, registers included."""
    flags = _stream_flags("k2_occupancy", streams[0], "dy", streams[1])
    lib = _library_bwd()
    out = (ctypes.c_int * 5)()
    err = lib.ss2d_scan_bwd_occupancy(D_STATE, R, T, *flags, out)
    if err != 0:
        raise RuntimeError(f"ss2d_scan_bwd_occupancy failed: {lib.ss2d_scan_bwd_error_string(err).decode()}")
    keys = ("threads", "smem_local", "smem_main", "blocks_per_sm_local", "blocks_per_sm_main")
    return dict(zip(keys, out))


K3_GROUP = 64  # channels a selective_chunk block scans
K3_THREADS = 4 * K3_GROUP  # a quad of threads per channel
K3_SCAN_BLOCKS = 4  # resident blocks an SM selective_chunk's launch bounds ask for
K3_PREFIX_BATCH = 8  # chunks a selective_prefix worker loads at once, one worker for each


def k3_plan(B, K, L, D, N, T, sms):
    """K3's launch geometry, from shapes alone (the kernel's source,
    `csrc/selective_scan.cu`, sizes its tiles by the same sums, and refuses a
    launch whose shared memory is not this plan's).

    selective_chunk (pass 1 and the replay) runs `threads` a block on a grid
    of (chunks, B * K streams, channel groups of 64); its dynamic shared
    memory `smem_scan` holds B and C of the chunk's T tokens and (da, u) of
    each (token, channel of the group). selective_prefix runs one block per
    K1_PREFIX_LANES (n, d) lanes of each stream, with a worker a lane for
    every K3_PREFIX_BATCH chunks up to K1_PREFIX_WORKERS (`prefix_threads`),
    on static shared memory `smem_prefix`; its launch bounds hold it to 32
    registers, so threads and shared memory set its residency. For each, the
    blocks and warps an SM that shared memory, 2,048 threads and the register
    budget of the kernel's launch bounds let reside (the registers used are
    the card's to report: `k3_occupancy`), and selective_chunk's blocks
    against what `sms` SMs hold at once (`waves_scan`)."""
    if N != D_STATE or not 1 <= D <= MAX_D_K3:
        raise ValueError(f"k3_plan: K3 takes N={D_STATE}, D<={MAX_D_K3}; got N={N}, D={D}")
    if not 1 <= T <= CHUNK:
        raise ValueError(f"k3_plan: K3 takes chunks of 1 <= T <= {CHUNK} tokens; got T={T}")
    nc = -(-L // T)
    smem_scan = 4 * (T * 2 * N + 2 * T * K3_GROUP)
    workers = min(K1_PREFIX_WORKERS, -(-nc // K3_PREFIX_BATCH))
    return _scan_plan(K3_THREADS, smem_scan, K3_SCAN_BLOCKS, (nc, B * K, -(-D // K3_GROUP)),
                      K1_PREFIX_LANES * workers, BLOCKS_PER_SM,
                      (-(-N * D // K1_PREFIX_LANES), B * K), sms)


def k3_occupancy(D=64, L=65_536, T=CHUNK):
    """What the card reports for K3's kernels (N = 16) at the launch's
    threads and shared memory for D channels and L tokens a stream (which
    set selective_prefix's workers): {threads, smem_scan,
    blocks_per_sm_pass1, blocks_per_sm_replay, prefix_threads,
    blocks_per_sm_prefix} from `cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
    registers included."""
    lib = _library_k3()
    out = (ctypes.c_int * 6)()
    err = lib.selective_scan_occupancy(D_STATE, D, L, T, out)
    if err != 0:
        raise RuntimeError(f"selective_scan_occupancy failed: {lib.selective_scan_error_string(err).decode()}")
    keys = ("threads", "smem_scan", "blocks_per_sm_pass1", "blocks_per_sm_replay",
            "prefix_threads", "blocks_per_sm_prefix")
    return dict(zip(keys, out))


K4_QUAD, K4_SUB = 4, 8  # threads a channel; tokens a sub-tile of bwd_main


def k4_plan(B, K, L, D, N, T, sms):
    """K4's launch geometry, from shapes alone (the kernel's source,
    `csrc/selective_scan_bwd.cu`, sizes its tiles by the same sums).

    A block holds DM = 64 channels where D <= 64, else 128, a quad of threads
    each: `threads` = 4 DM in both kernels. Returns that, the dynamic shared
    memory of `bwd_local` (C of the chunk, (da, dy) of each (token, channel))
    and of `bwd_main` (B and C of the chunk, (da, u, sigmoid(z), dy) of each
    (token, channel), h at the head of each sub-tile, the warps' sums over
    channels of a sub-tile) in bytes, the blocks and warps of each that the
    SM's shared memory, 2,048 threads and the launch bounds' register budget
    let reside (the registers used are the card's to report: `k4_occupancy`),
    and `gx`, the blocks of `bwd_main` for each of the K directions, which
    stride over that direction's B * ceil(L / T) chunks: as many in all as
    reside at once on `sms` SMs, one whole wave."""
    if N != D_STATE or not 1 <= D <= MAX_D_K4:
        raise ValueError(f"k4_plan: K4 takes N={D_STATE}, D<={MAX_D_K4}; got N={N}, D={D}")
    if not K4_SUB <= T <= CHUNK or T % K4_SUB:
        raise ValueError(f"k4_plan: K4 takes chunks of T <= {CHUNK} tokens, a multiple of "
                         f"{K4_SUB}; got T={T}")
    dm = 64 if D <= 64 else 128
    threads = K4_QUAD * dm
    smem_local = 4 * (T * N + 2 * T * dm)
    smem_main = 4 * (T * 2 * N + 4 * T * dm + (T // K4_SUB) * dm * N + (dm // 8) * K4_SUB * 2 * N)
    # The launch bounds ask for 32 warps an SM of bwd_local and 16 of bwd_main.
    local = min(_resident(threads, smem_local), 1024 // threads)
    main = min(_resident(threads, smem_main), 512 // threads)
    gx = max(1, min(B * -(-L // T), sms * main // K))
    return {"threads": threads, "smem_local": smem_local, "smem_main": smem_main,
            "blocks_per_sm_local": local, "blocks_per_sm_main": main,
            "warps_per_sm_local": local * threads // 32, "warps_per_sm_main": main * threads // 32,
            "gx": gx}


def k4_occupancy(D=64, T=CHUNK):
    """What the card reports for K4's kernels (N = 16) at the launch's
    threads and shared memory for D channels: {threads, smem_local,
    smem_main, blocks_per_sm_local, blocks_per_sm_main} from
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`, registers included."""
    lib = _library_k4()
    out = (ctypes.c_int * 5)()
    err = lib.selective_scan_bwd_occupancy(D_STATE, D, T, out)
    if err != 0:
        raise RuntimeError("selective_scan_bwd_occupancy failed: "
                           f"{lib.selective_scan_bwd_error_string(err).decode()}")
    keys = ("threads", "smem_local", "smem_main", "blocks_per_sm_local", "blocks_per_sm_main")
    return dict(zip(keys, out))


def ss2d_scan_pair_bwd(x, wx, dtw, bias, A, dsk, state, sumda, dy):
    """Backward of `ss2d_scan_pair` (kernel K2).

    `state`, `sumda`: what the forward returns with `return_carries`; dy:
    (B, 2, L, D), float32 or bf16. Returns (dx, dwx, ddtw, dbias, dA, ddsk),
    dx (B, L, D) in x's dtype, each member's rounded to it and the two added
    in it, the rest float32 in the layouts of wx, dtw, bias, A and dsk.
    On the card (x, dy) is one of `STREAM_PAIRS`: bf16 x takes float32 or
    bf16 dy, float32 x float32 dy.
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
    _check_inputs("ss2d_scan_pair_bwd", x, shapes, MAX_D_BWD, ("x", "dy"))
    flags = _stream_flags("ss2d_scan_pair_bwd", x.dtype, "dy", dy.dtype)
    lib = _library_bwd()
    j = r + 2 * n
    rows = j + r + 1 + n + 1  # dwx | ddtw | dbias | dA | ddsk
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    gx = k2_plan(b, length, d, n, r, CHUNK, sms)["gx"]
    dx = torch.empty_like(x)
    gcar = torch.empty_like(state)
    part = torch.empty((gx, rows, 2, d), device=x.device, dtype=torch.float32)
    sums = torch.empty((rows, 2, d), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ss2d_scan_pair_bwd(
            x.data_ptr(), wx.data_ptr(), dtw.data_ptr(), bias.data_ptr(), A.data_ptr(),
            dsk.data_ptr(), state.data_ptr(), sumda.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), gcar.data_ptr(), part.data_ptr(), sums.data_ptr(),
            b, length, d, n, r, CHUNK, gx, *flags, stream)
    if err != 0:
        raise RuntimeError("ss2d_scan_pair_bwd launch failed: "
                           f"{lib.ss2d_scan_bwd_error_string(err).decode()}")
    ss2d_scan_pair_bwd.launches += 1
    return (dx, sums[:j].permute(1, 2, 0).contiguous(),
            sums[j:j + r].transpose(0, 1).contiguous(), sums[j + r],
            sums[j + r + 1:j + r + 1 + n].transpose(0, 1).contiguous(), sums[j + r + 1 + n])


ss2d_scan_pair_bwd.launches = 0


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
    each chunk's sum of da. The launch takes `k3_plan`'s shared memory (the
    source refuses any other)."""
    args = (u, delta, A, Bs, Cs, D_skip, delta_bias)
    _check_scan_inputs("selective_scan_cuda", u, _scan_shapes(*args), MAX_D_K3)
    b, k, length, d = u.shape
    n = A.shape[-1]
    lib = _library_k3()
    plan = k3_plan(b, k, length, d, n, CHUNK, _sm_count(u.device.index))
    # The kernel reads the inputs 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied.
    args = tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in args)
    nc = -(-length // CHUNK)
    y = torch.empty_like(u)
    state = torch.empty((b, k, nc, n, d), device=u.device, dtype=torch.float32)
    sumda = torch.empty((b, k, nc, d), device=u.device, dtype=torch.float32)
    with _on_device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_fwd_f32(
            *(t.data_ptr() for t in args), y.data_ptr(), state.data_ptr(), sumda.data_ptr(),
            b, k, length, d, n, CHUNK, plan["smem_scan"], stream)
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
    D_skip, delta_bias: (K, D). u, delta, Bs and Cs may be bf16: they are
    widened to float32 here, before either version runs. Returns y (B, K, L,
    D) float32. Both the kernel and the plain version work in chunks of
    `CHUNK` tokens. With
    `return_carries` also the chunk-entry states (B, K, nc, N, D) and the
    chunks' sums of da (B, K, nc, D), detached. Differentiable: when an input
    requires grad the call goes through `SelectiveScan`, whose backward is K4.
    Counts its kernel launches in `selective_scan_cuda.launches`.
    """
    args = tuple(t.float() if t.dtype == torch.bfloat16 else t
                 for t in (u, delta, A, Bs, Cs, D_skip, delta_bias))
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
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    gx = k4_plan(b, k, length, d, n, CHUNK, sms)["gx"]
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bs), torch.empty_like(Cs)
    gcar = torch.empty_like(state)
    part = torch.empty((k, gx, n + 2, d), device=u.device, dtype=torch.float32)
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
