"""Dataset transforms on numpy HWC images, host side. The counterpart of
`wavemamba_tpu/data/transforms.py`. The random crop and the dihedral
augmentation draw from python's `random` (seeded by
`utils.misc.set_random_seed`) and work on views; the batch is copied once
when it is assembled."""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img, scale):
    """Crop H, W down to multiples of scale."""
    img = img.copy()
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale, gt_path=None):
    """Random crop of corresponding GT / LQ patches (images or lists of them)."""
    if not isinstance(img_gts, list):
        img_gts = [img_gts]
    if not isinstance(img_lqs, list):
        img_lqs = [img_lqs]
    h_lq, w_lq = img_lqs[0].shape[:2]
    h_gt, w_gt = img_gts[0].shape[:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x multiplication of "
                         f"LQ ({h_lq}, {w_lq}).")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq}, {w_lq}) is smaller than patch size ({lq_patch_size}, "
                         f"{lq_patch_size}). Please remove {gt_path}.")
    top = random.randint(0, h_lq - lq_patch_size)
    left = random.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top : top + lq_patch_size, left : left + lq_patch_size, ...] for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt : top_gt + gt_patch_size, left_gt : left_gt + gt_patch_size, ...]
               for v in img_gts]
    if len(img_gts) == 1:
        img_gts = img_gts[0]
    if len(img_lqs) == 1:
        img_lqs = img_lqs[0]
    return img_gts, img_lqs


def augment(imgs, hflip=True, rotation=True, flows=None, return_status=False):
    """Random hflip / vflip / transpose of images (and optical flows)."""
    hflip = hflip and random.random() < 0.5
    vflip = rotation and random.random() < 0.5
    rot90 = rotation and random.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.transpose(1, 0)
        return np.ascontiguousarray(img)

    def _augment_flow(flow):
        if hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    if not isinstance(imgs, list):
        imgs = [imgs]
    imgs = [_augment(img) for img in imgs]
    if len(imgs) == 1:
        imgs = imgs[0]
    if flows is not None:
        if not isinstance(flows, list):
            flows = [flows]
        flows = [_augment_flow(f) for f in flows]
        if len(flows) == 1:
            flows = flows[0]
        return imgs, flows
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs


def data_augmentation(image, mode):
    """One of the 8 dihedral modes."""
    k, flip = divmod(mode, 2)
    if not 0 <= mode <= 7:
        raise ValueError("Invalid choice of image transformation")
    out = np.rot90(image, k=k) if k else image
    return (np.flipud(out) if flip else out).copy()


def random_augmentation(*args):
    """Apply one random dihedral mode (1-7) to all inputs."""
    flag_aug = random.randint(1, 7)
    return [data_augmentation(data, flag_aug) for data in args]
