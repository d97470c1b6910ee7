"""Image IO and conversion, NHWC. The counterpart of
`wavemamba_tpu/utils/img_util.py`: disk IO is BGR uint8 through OpenCV,
the model sees (1, H, W, 3) RGB float32. `cv2` is imported by the functions
that decode, encode or pad with it only, so the rest of the port runs where
OpenCV is missing."""

from __future__ import annotations

import os

import numpy as np

from wavemamba_torch.utils import frames
from wavemamba_torch.utils.profiler import annotate


def imfrombytes(content: bytes, flag="color", float32=False):
    """Decode an image file's bytes -> BGR HWC uint8 (or float32 in [0, 1])."""
    import cv2

    flags = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    img = cv2.imdecode(np.frombuffer(content, np.uint8), flags[flag])
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imread(path, flag="color", float32=False):
    """Read an image file -> BGR HWC uint8 (or float32 in [0, 1])."""
    with open(path, "rb") as f:
        return imfrombytes(f.read(), flag=flag, float32=float32)


def imwrite(img, file_path, params=None, auto_mkdir=True):
    """Write a BGR uint8 HWC image."""
    import cv2

    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)), exist_ok=True)
    if not cv2.imwrite(file_path, img, params or []):
        raise IOError(f"failed to write {file_path}")
    return True


def img2batch(img, bgr2rgb=True, float32=True):
    """HWC BGR (uint8 or float) -> (1, H, W, C) RGB float32 in [0, 1].

    A uint8 (H, W, 3) frame, strided in any way, at the default flags takes
    the native frame pass (`utils/frames.py`), the same bits as the numpy
    route below; each such call counts in `img2batch.fused_calls`. Every
    other input, and every input where the library cannot be built, takes
    the numpy route."""
    with annotate("wm.img2batch"):
        img = np.asarray(img)
        if bgr2rgb and float32 and frames.strided_frame(img, np.uint8) and frames.available():
            batch = frames.bgr_u8_to_rgb_batch(img)
            img2batch.fused_calls += 1
            return batch
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if bgr2rgb and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        if float32:
            img = img.astype(np.float32)
        batch = img[None].copy()
        del img  # the float temporary is freed inside the span, not after it
    return batch


img2batch.fused_calls = 0


def batch2img(batch, rgb2bgr=True, min_max=(0, 1)):
    """(1|B, H, W, C) RGB float -> uint8 BGR HWC of the first item: clamp
    to min_max, rescale to [0, 1], *255 and round.

    A float32 item of 3 channels, strided in any way (the model's output
    is channel-planar), with `rgb2bgr` and `min_max` (0, 1) takes the native
    frame pass (`utils/frames.py`), the same bits as the numpy route below;
    each such call counts in `batch2img.fused_calls`. Every other input, and
    every input where the library cannot be built, takes the numpy route."""
    with annotate("wm.batch2img"):
        img = np.asarray(batch)
        if img.ndim == 4:
            img = img[0]
        # A numpy scalar in min_max would promote the numpy route to float64.
        unit = all(type(v) in (int, float) for v in min_max) and tuple(min_max) == (0, 1)
        if rgb2bgr and unit and frames.strided_frame(img, np.float32) and frames.available():
            out = frames.rgb_f32_to_bgr_u8(img)
            batch2img.fused_calls += 1
            return out
        img = np.clip(img, min_max[0], min_max[1])
        img = (img - min_max[0]) / (min_max[1] - min_max[0])
        if rgb2bgr and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        out = (img * 255.0).round().astype(np.uint8)
        del img  # the float temporary is freed inside the span, not after it
    return out


batch2img.fused_calls = 0


def padding(img_lq, img_gt, gt_size):
    """Reflect-pad a pair bottom/right up to gt_size (OpenCV's BORDER_REFLECT,
    which repeats the edge pixel)."""
    import cv2

    h, w = img_lq.shape[:2]
    h_pad = max(0, gt_size - h)
    w_pad = max(0, gt_size - w)
    if h_pad == 0 and w_pad == 0:
        return img_lq, img_gt
    img_lq = cv2.copyMakeBorder(img_lq, 0, h_pad, 0, w_pad, cv2.BORDER_REFLECT)
    img_gt = cv2.copyMakeBorder(img_gt, 0, h_pad, 0, w_pad, cv2.BORDER_REFLECT)
    if img_lq.ndim == 2:
        img_lq = img_lq[..., None]
    if img_gt.ndim == 2:
        img_gt = img_gt[..., None]
    return img_lq, img_gt


def crop_border(imgs, crop_size):
    """`crop_size` pixels cropped from each border of an HWC image, or of
    each image of a list."""
    if crop_size == 0:
        return imgs
    if isinstance(imgs, list):
        return [v[crop_size:-crop_size, crop_size:-crop_size, ...] for v in imgs]
    return imgs[crop_size:-crop_size, crop_size:-crop_size, ...]
