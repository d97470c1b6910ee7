"""MATLAB-parity colour conversion for the metrics. The counterpart of
`wavemamba_tpu/utils/color.py`.

Float inputs in [0, 1] give float outputs scaled to [0, 1]; uint8 inputs
give uint8 outputs."""

from __future__ import annotations

import numpy as np

_Y_COEF_RGB = np.array([65.481, 128.553, 24.966])
_CBCR_RGB = np.array(
    [[65.481, -37.797, 112.0], [128.553, -74.203, -93.786], [24.966, 112.0, -18.214]]
)


def _convert_input(img):
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.0
    elif img_type not in (np.float32, np.float64):
        raise TypeError(f"The img type should be np.float32 or np.uint8, but got {img_type}")
    return img, img_type


def _convert_output(img, img_type):
    if img_type == np.uint8:
        return img.round().astype(np.uint8)
    return (img / 255.0).astype(np.float32)


def rgb2ycbcr(img, y_only=False):
    img, t = _convert_input(img)
    if y_only:
        out = img @ _Y_COEF_RGB + 16.0  # consumes the channel axis: HW
    else:
        out = img @ _CBCR_RGB + np.array([16.0, 128.0, 128.0])
    return _convert_output(out, t)


def bgr2ycbcr(img, y_only=False):
    return rgb2ycbcr(img[..., ::-1], y_only=y_only)


def ycbcr2rgb(img):
    """The inverse BT.601 of MATLAB's `ycbcr2rgb`, with its constants."""
    img, t = _convert_input(img)
    mat = np.array([[0.00456621, 0.00456621, 0.00456621], [0.0, -0.00153632, 0.00791071],
                    [0.00625893, -0.00318811, 0.0]])
    out = (img * 255.0) @ mat * 255.0 + np.array([-222.921, 135.576, -276.836])
    return _convert_output(out, t)


def ycbcr2bgr(img):
    return ycbcr2rgb(img)[..., ::-1]


def to_y_channel(img):
    """img in [0, 255] HWC BGR -> Y channel in [0, 255] (HW1 float)."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)
        if img.ndim == 2:
            img = img[..., None]
    return img * 255.0
