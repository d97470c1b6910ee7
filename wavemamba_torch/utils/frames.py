"""ctypes bindings of the request path's two frame conversions
(`csrc/frames.cc`): uint8 BGR frame -> float32 RGB batch, and float32 RGB
item -> uint8 BGR frame, one C++ pass each with its rows split over the
CPUs this process may use, the bits of `img_util`'s numpy route. Host code;
no device kernel.

The library is built with g++ at first use and loaded through
`utils/cxx.py` (into its build directory, `build/wavemamba_torch/` by
default). `available()` is False where g++ or the build fails; `img_util`
then takes its numpy route.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from wavemamba_torch.utils import cxx

SOURCE = cxx.CSRC / "frames.cc"
STEM = "libwmframes"


def build() -> Path:
    """Compile `csrc/frames.cc` into a shared library; returns its path."""
    return cxx.build(SOURCE, STEM)


@functools.cache
def _load():
    """The bound library, or None where it cannot be built or loaded."""
    # src, its (row, pixel, channel) strides in elements, h, w, dst, threads
    args = [ctypes.c_void_p, *[ctypes.c_int64] * 3, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int]
    try:
        return cxx.load(SOURCE, {"bgr_u8_to_rgb_f32": (args, None),
                                 "rgb_f32_to_bgr_u8": (args, None)}, stem=STEM)
    except (OSError, RuntimeError):
        return None


def available() -> bool:
    return _load() is not None


def strided_frame(img, dtype) -> bool:
    """True where `img` is an aligned (h, w, 3) array of `dtype` (so its
    strides are whole elements), which the conversions read in place
    whatever its strides: a crop's view, a reversed axis, or the model's
    channel-planar output seen as (h, w, 3)."""
    return img.dtype == dtype and img.ndim == 3 and img.shape[2] == 3 and img.flags.aligned


def _call(name, img, dtype, out):
    """`name` of the library from `img` into `out`, rows over the CPUs this
    process may use; raises for an `img` that `strided_frame` refuses."""
    lib = _load()
    if lib is None:
        raise RuntimeError("frame library unavailable (g++ or its build failed)")
    if not strided_frame(img, dtype):
        raise ValueError(f"an aligned {np.dtype(dtype)} (h, w, 3), got {img.dtype} {img.shape} "
                         f"aligned={img.flags.aligned}")
    h, w = img.shape[:2]
    strides = [s // img.itemsize for s in img.strides]
    getattr(lib, name)(img.ctypes.data, *strides, h, w, out.ctypes.data,
                       len(os.sched_getaffinity(0)))
    return out


def bgr_u8_to_rgb_batch(img):
    """uint8 (h, w, 3) BGR -> a fresh float32 (1, h, w, 3) RGB batch in [0,
    1]: the bits of numpy's `img[..., ::-1].astype(float32) / 255.0`."""
    return _call("bgr_u8_to_rgb_f32", img, np.uint8, np.empty((1, *img.shape), np.float32))


def rgb_f32_to_bgr_u8(img):
    """float32 (h, w, 3) RGB -> a fresh uint8 (h, w, 3) BGR frame: the bits of
    numpy's `(clip(img, 0, 1)[..., ::-1] * 255.0).round().astype(uint8)`
    (NaN gives 0, as numpy's cast gives on x86-64)."""
    return _call("rgb_f32_to_bgr_u8", img, np.float32, np.empty(img.shape, np.uint8))
