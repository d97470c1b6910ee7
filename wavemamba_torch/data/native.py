"""ctypes bindings of the native data-loader core (`native/wavedata.cc`):
crop + dihedral augment + BGR->RGB + normalize (+ batch collate) of decoded
uint8 images in one C++ pass, threaded across a batch. The counterpart of
`wavemamba_tpu/data/native.py`. Host code; no device kernel.

The library is built from the repository's source with `native/build.sh`'s
`g++` flags at first use and loaded through `utils/cxx.py`, into its build
directory (`build/wavemamba_torch/` by default; named by the hash of the
source, the flags and the host's CPU, since `-march=native` ties it to the
CPU). `available()` is False where `g++` or the build fails; the
dataset then takes the numpy route, as in the JAX package, and draws the
same crops. `paired_crop_augment_plain` and `batch_draws` are the numpy
versions of the two entry points, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from wavemamba_torch.utils import cxx
from wavemamba_torch.utils.cxx import CXX_FLAGS, ROOT  # noqa: F401 (native/build.sh's flags)

SOURCE = ROOT / "native" / "wavedata.cc"
STEM = "libwavedata"
_INV255 = np.float32(1.0) / np.float32(255.0)  # the C++ pass's `1.0f / 255.0f`
_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def build() -> Path:
    """Compile `native/wavedata.cc` into a shared library; returns its path.
    An unchanged build on the same CPU is made once."""
    return cxx.build(SOURCE, STEM)


@functools.cache
def _load():
    """The bound library, or None where it cannot be built or loaded."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    i = ctypes.c_int
    table = {"wd_paired_crop_augment": ([u8p, u8p, *[i] * 8, f32p, f32p], None),
             "wd_batch_paired_crop_augment": ([ctypes.POINTER(u8p), ctypes.POINTER(u8p), i32p,
                                               i32p, i, i, i, ctypes.c_uint64, i, i, f32p, f32p,
                                               i], None),
             "wd_to_float_rgb": ([u8p, i, i, i, i, f32p], None)}
    try:
        return cxx.load(SOURCE, table, stem=STEM)
    except (OSError, RuntimeError):
        return None


def available() -> bool:
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ or its build failed)")
    return lib


def _as_u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_f32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_pair(gt, lq, top, left, gt_size, mode):
    if gt.dtype != np.uint8 or lq.dtype != np.uint8 or gt.ndim != 3 or gt.shape != lq.shape:
        raise ValueError(f"uint8 HWC pairs of one shape, got {gt.dtype} {gt.shape} and "
                         f"{lq.dtype} {lq.shape}")
    h, w = gt.shape[:2]
    if not (0 <= top <= h - gt_size and 0 <= left <= w - gt_size):
        raise ValueError(f"crop ({top}, {left}) + {gt_size} outside {h}x{w}")
    if not 0 <= mode <= 7:
        raise ValueError(f"dihedral mode {mode} not in 0-7")


def paired_crop_augment(gt, lq, top, left, gt_size, mode, bgr2rgb=True):
    """Deterministic single-pair crop + augment. gt/lq: uint8 HWC (same size).

    Returns (gt_out, lq_out) float32 (gt_size, gt_size, C) RGB."""
    lib = _library()
    gt, lq = np.ascontiguousarray(gt), np.ascontiguousarray(lq)
    _check_pair(gt, lq, top, left, gt_size, mode)
    h, w, c = gt.shape
    out_gt = np.empty((gt_size, gt_size, c), np.float32)
    out_lq = np.empty((gt_size, gt_size, c), np.float32)
    lib.wd_paired_crop_augment(_as_u8p(gt), _as_u8p(lq), h, w, c, top, left, gt_size, mode,
                               int(bgr2rgb), _as_f32p(out_gt), _as_f32p(out_lq))
    return out_gt, out_lq


def batch_paired_crop_augment(gts, lqs, gt_size, seed, geometric=True, bgr2rgb=True,
                              n_threads=0):
    """gts/lqs: lists of uint8 HWC arrays (per-item sizes may differ).

    Returns (gt_batch, lq_batch) float32 (N, S, S, C) RGB. Deterministic in
    (seed, item index): the crops and modes are `batch_draws`'. Threaded in
    C++ (n_threads=0 -> one thread an item, up to the CPU count)."""
    lib = _library()
    n = len(gts)
    gts = [np.ascontiguousarray(g) for g in gts]
    lqs = [np.ascontiguousarray(q) for q in lqs]
    for g, q in zip(gts, lqs, strict=True):
        _check_pair(g, q, 0, 0, gt_size, 0)
    c = gts[0].shape[2]
    if any(g.shape[2] != c for g in gts):
        raise ValueError("every item of a batch has the same channels")
    hs = np.asarray([g.shape[0] for g in gts], np.int32)
    ws = np.asarray([g.shape[1] for g in gts], np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    gt_ptrs = (u8p * n)(*[_as_u8p(g) for g in gts])
    lq_ptrs = (u8p * n)(*[_as_u8p(q) for q in lqs])
    out_gt = np.empty((n, gt_size, gt_size, c), np.float32)
    out_lq = np.empty((n, gt_size, gt_size, c), np.float32)
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    lib.wd_batch_paired_crop_augment(
        gt_ptrs, lq_ptrs, hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n, c, gt_size, int(seed) & _MASK64,
        int(geometric), int(bgr2rgb), _as_f32p(out_gt), _as_f32p(out_lq), n_threads)
    return out_gt, out_lq


def to_float_rgb(img):
    """uint8 HWC BGR -> float32 HWC RGB via the native pass (numpy where the
    library is unavailable)."""
    img = np.ascontiguousarray(img)
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(img[..., ::-1].astype(np.float32) / 255.0)
    h, w, c = img.shape
    out = np.empty((h, w, c), np.float32)
    lib.wd_to_float_rgb(_as_u8p(img), h, w, c, 1, _as_f32p(out))
    return out


# ---------------------------------------------------------------------------
# The numpy versions of the C++ pass, bit for bit.


def _dihedral(img, mode):
    """`transforms.data_augmentation`'s mode (rot90 counter-clockwise k = mode
    // 2 times, then flipud for odd modes), as a view."""
    out = np.rot90(img, k=mode // 2)
    return out[::-1] if mode % 2 else out


def paired_crop_augment_plain(gt, lq, top, left, gt_size, mode, bgr2rgb=True):
    """`paired_crop_augment` in numpy: the crop, the dihedral mode, the
    channel swap and the C++ pass's multiply by the float32 1/255 (the
    numpy route of the dataset divides by 255, which can differ in the last
    bit)."""
    _check_pair(gt, lq, top, left, gt_size, mode)

    def one(img):
        tile = _dihedral(img[top:top + gt_size, left:left + gt_size], mode)
        if bgr2rgb and tile.shape[2] == 3:
            tile = tile[..., ::-1]
        return tile.astype(np.float32) * _INV255

    return one(gt), one(lq)


def _splitmix64(state):
    state = (state + _GOLDEN) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


def batch_draws(hs, ws, gt_size, seed, geometric=True):
    """The (top, left, mode) that `batch_paired_crop_augment` draws for each
    item of sizes (hs[i], ws[i]): splitmix64 from seed + golden * (i + 1),
    as `native/wavedata.cc` does."""
    draws = []
    for i, (h, w) in enumerate(zip(hs, ws)):
        s = (int(seed) + _GOLDEN * (i + 1)) & _MASK64
        s, r1 = _splitmix64(s)
        s, r2 = _splitmix64(s)
        s, r3 = _splitmix64(s)
        max_top, max_left = h - gt_size, w - gt_size
        draws.append((r1 % (max_top + 1) if max_top > 0 else 0,
                      r2 % (max_left + 1) if max_left > 0 else 0,
                      1 + r3 % 7 if geometric else 0))
    return draws
