"""Optical-flow IO (`basicsr/utils/flow_util.py:7-170`): .flo read/write and
quantized flow images. The counterpart of `wavemamba_tpu/utils/flow_util.py`;
`cv2` is imported by the functions that read or write images."""

from __future__ import annotations

import numpy as np


def flowread(flow_path, quantize=False, concat_axis=0):
    if quantize:
        import cv2

        cat_flow = cv2.imread(str(flow_path), cv2.IMREAD_UNCHANGED)
        if cat_flow.ndim != 2:
            raise IOError(f"{flow_path} is not a valid quantized flow file.")
        assert cat_flow.shape[concat_axis] % 2 == 0
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy)
    with open(str(flow_path), "rb") as f:
        header = f.read(4).decode("utf-8")
        if header != "PIEH":
            raise IOError(f"Invalid flow file: {flow_path}, header does not contain PIEH")
        w = np.fromfile(f, np.int32, 1).squeeze()
        h = np.fromfile(f, np.int32, 1).squeeze()
        return np.fromfile(f, np.float32, int(w) * int(h) * 2).reshape((int(h), int(w), 2))


def flowwrite(flow, filename, quantize=False, concat_axis=0):
    if not quantize:
        with open(str(filename), "wb") as f:
            f.write("PIEH".encode("utf-8"))
            np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
        return
    import cv2

    dx, dy = quantize_flow(flow)
    cv2.imwrite(str(filename), np.concatenate([dx, dy], axis=concat_axis))


def quantize_flow(flow, max_val=0.02, norm=True):
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    out = []
    for d in (dx, dy):
        d = np.clip(d, -max_val, max_val)
        q = np.minimum(
            np.floor((d - (-max_val)) / (2 * max_val) * 255), 255 - 1
        ).astype(np.uint8)
        out.append(q)
    return out


def dequantize_flow(dx, dy, max_val=0.02, denorm=True):
    assert dx.shape == dy.shape
    dx = (dx.astype(np.float32) + 0.5) / 255 * 2 * max_val - max_val
    dy = (dy.astype(np.float32) + 0.5) / 255 * 2 * max_val - max_val
    if denorm:
        dx *= dx.shape[1]
        dy *= dy.shape[0]
    return np.dstack((dx, dy))
