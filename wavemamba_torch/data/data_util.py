"""Path pairing (folders, meta-info files, lmdb folders) and the video
helpers (frame sequences, frame indices, DUF downsampling). The counterpart
of `wavemamba_tpu/data/data_util.py` (`basicsr/data/data_util.py`)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from wavemamba_torch.data.transforms import mod_crop
from wavemamba_torch.utils.misc import scandir


def paired_paths_from_folder(folders, keys, filename_tmpl="{}"):
    """Pair the files of an LQ folder and a GT folder by stem."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    if len(input_paths) != len(gt_paths):
        raise ValueError(f"{input_key} and {gt_key} datasets have different number of images: "
                         f"{len(input_paths)}, {len(gt_paths)}.")
    input_names = {os.path.basename(p) for p in input_paths}
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = os.path.splitext(os.path.basename(gt_path))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        if input_name not in input_names:
            raise ValueError(f"{input_name} is not in {input_key}_paths.")
        paths.append({f"{input_key}_path": os.path.join(input_folder, input_name),
                      f"{gt_key}_path": os.path.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file, filename_tmpl="{}"):
    """Pair from a meta-info text file of GT names."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, "r") as fin:
        gt_names = [line.strip().split(" ")[0] for line in fin]
    paths = []
    for gt_name in gt_names:
        basename, ext = os.path.splitext(os.path.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({f"{input_key}_path": os.path.join(input_folder, input_name),
                      f"{gt_key}_path": os.path.join(gt_folder, gt_name)})
    return paths


def paths_from_folder(folder):
    return [os.path.join(folder, p) for p in sorted(scandir(folder))]


def paired_paths_from_lmdb(folders, keys):
    """Pair two lmdb folders by the keys of their `meta_info.txt` (reading
    them needs no `lmdb` package)."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (input_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError(
            f"{input_key} folder and {gt_key} folder should both in lmdb formats. "
            f"But received {input_key}: {input_folder}; {gt_key}: {gt_folder}")
    with open(os.path.join(input_folder, "meta_info.txt")) as fin:
        input_lmdb_keys = [line.split(".")[0] for line in fin]
    with open(os.path.join(gt_folder, "meta_info.txt")) as fin:
        gt_lmdb_keys = [line.split(".")[0] for line in fin]
    if set(input_lmdb_keys) != set(gt_lmdb_keys):
        raise ValueError(f"Keys in {input_key}_folder and {gt_key}_folder are different.")
    return [{f"{input_key}_path": k, f"{gt_key}_path": k} for k in sorted(input_lmdb_keys)]


def paths_from_lmdb(folder):
    if not folder.endswith(".lmdb"):
        raise ValueError(f"Folder {folder} should be in lmdb format.")
    with open(os.path.join(folder, "meta_info.txt")) as fin:
        return [line.split(".")[0] for line in fin]


# ---------------------------------------------------------------------------
# Video-sequence helpers (`basicsr/data/data_util.py:12-87,338-390`). No
# shipped configuration reads video; they complete the data layer's API.


def read_img_seq(path, require_mod_crop=False, scale=1):
    """Read an image-sequence folder (or explicit path list) into a
    (T, H, W, C) float32 RGB array in [0, 1] (NHWC, as the JAX package)."""
    import cv2

    if isinstance(path, list):
        img_paths = path
    else:
        img_paths = [os.path.join(path, p) for p in sorted(scandir(path))]
    imgs = [cv2.imread(p).astype(np.float32) / 255.0 for p in img_paths]
    if require_mod_crop:
        imgs = [mod_crop(img, scale) for img in imgs]
    return np.stack([img[:, :, ::-1] for img in imgs], axis=0)


def generate_frame_indices(crt_idx, max_frame_num, num_frames, padding="reflection"):
    """Center-frame neighbourhood indices with boundary padding:
    'replicate' | 'reflection' | 'reflection_circle' | 'circle'."""
    if num_frames % 2 != 1:
        raise ValueError("num_frames should be an odd number.")
    if padding not in ("replicate", "reflection", "reflection_circle", "circle"):
        raise ValueError(f"Wrong padding mode: {padding}.")
    max_frame_num = max_frame_num - 1  # 0-based last index
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            pad_idx = {"replicate": 0, "reflection": -i,
                       "reflection_circle": crt_idx + num_pad - i,
                       "circle": num_frames + i}[padding]
        elif i > max_frame_num:
            pad_idx = {"replicate": max_frame_num,
                       "reflection": max_frame_num * 2 - i,
                       "reflection_circle": (crt_idx - num_pad) - (i - max_frame_num),
                       "circle": i - num_frames}[padding]
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def generate_gaussian_kernel(kernel_size=13, sigma=1.6):
    """Gaussian kernel as a smoothed dirac (float64 numpy)."""
    from scipy.ndimage import gaussian_filter

    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x, kernel_size=13, scale=4):
    """DUF-style Gaussian downsampling on x's device: reflect pad by
    kernel_size // 2 + 2 * scale, a depthwise Gaussian (sigma 0.4 * scale)
    at stride `scale`, then a crop of 2 on each side.

    x: (T, H, W, C) or (B, T, H, W, C) float tensor (or array), NHWC.
    Returns the same rank in float32 with H, W downsampled by `scale`."""
    if scale not in (2, 3, 4):
        raise ValueError(f"Only support scale (2, 3, 4), but got {scale}.")
    x = torch.as_tensor(x).float()
    squeeze = x.dim() == 4
    if squeeze:
        x = x[None]
    b, t, h, w, c = x.shape
    pad = kernel_size // 2 + scale * 2
    xt = F.pad(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    k = torch.as_tensor(generate_gaussian_kernel(kernel_size, 0.4 * scale), dtype=torch.float32,
                        device=x.device)
    y = F.conv2d(xt, k.expand(c, 1, kernel_size, kernel_size), stride=scale, groups=c)
    y = y[:, :, 2:-2, 2:-2].permute(0, 2, 3, 1)
    y = y.reshape(b, t, y.shape[1], y.shape[2], c)
    return y[0] if squeeze else y
