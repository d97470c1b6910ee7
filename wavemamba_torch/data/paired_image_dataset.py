"""Paired LQ/GT dataset and the LQ-only dataset, numpy NHWC. The counterpart
of `wavemamba_tpu/data/paired_image_dataset.py`.

Train phase: reflect-pad to gt_size, paired random crop, optional 8-way
dihedral augmentation (`geometric_augs`), RGB HWC output: float32 in [0, 1],
or uint8 with `transfer_dtype: uint8` (a quarter of the bytes to the card; the
train step scales on the device). Val/test phase: full images. Items:
{'lq', 'gt', 'lq_path', 'gt_path'}. The float32 train phase at scale 1
without mean / std takes the fused C++ crop (`data/native.py`, `use_native`,
on by default) where its library builds, else the numpy route; both draw
the crop and the mode from `random` in the same order. The lmdb backend reads
the `meta_info.txt` of two `.lmdb` folders and needs the `lmdb` package.
"""

from __future__ import annotations

import random
import threading

import numpy as np

from wavemamba_torch.data import native
from wavemamba_torch.data.data_util import (
    paired_paths_from_folder,
    paired_paths_from_lmdb,
    paired_paths_from_meta_info_file,
    paths_from_folder,
    paths_from_lmdb,
)
from wavemamba_torch.data.transforms import paired_random_crop, random_augmentation
from wavemamba_torch.utils.file_client import FileClient
from wavemamba_torch.utils.img_util import imfrombytes, padding


def _normalize(img, mean, std):
    if mean is None and std is None:
        return img
    return (img - np.asarray(mean or 0.0, np.float32)) / np.asarray(std or 1.0, np.float32)


class PairedImageDataset:
    def __init__(self, opt: dict):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt.get("io_backend", {"type": "disk"}))
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        self.gt_folder, self.lq_folder = opt["dataroot_gt"], opt["dataroot_lq"]
        self.filename_tmpl = opt.get("filename_tmpl", "{}")
        # `cache_in_ram: true` keeps the decoded uint8 images after their first
        # access: PNG inflate is the host's main cost per image.
        self._cache = {} if opt.get("cache_in_ram") else None
        self._cache_lock = threading.Lock()

        folders = [self.lq_folder, self.gt_folder]
        if self.io_backend_opt["type"] == "lmdb":
            self.io_backend_opt["db_paths"] = folders
            self.io_backend_opt["client_keys"] = ["lq", "gt"]
            self.paths = paired_paths_from_lmdb(folders, ["lq", "gt"])
        elif opt.get("meta_info_file") is not None:
            self.paths = paired_paths_from_meta_info_file(
                folders, ["lq", "gt"], opt["meta_info_file"], self.filename_tmpl)
        else:
            self.paths = paired_paths_from_folder(folders, ["lq", "gt"], self.filename_tmpl)

    def __len__(self):
        return len(self.paths)

    def _load_u8(self, path, key):
        """Decoded uint8 BGR image, via the RAM cache when enabled."""
        if self._cache is None:
            return imfrombytes(self.file_client.get(path, key))
        img = self._cache.get(path)
        if img is None:
            img = imfrombytes(self.file_client.get(path, key))
            with self._cache_lock:
                self._cache[path] = img
        return img

    def __getitem__(self, index):
        if self.file_client is None:
            backend = dict(self.io_backend_opt)
            self.file_client = FileClient(backend.pop("type"), **backend)
        scale = self.opt.get("scale", 1)
        train = self.opt.get("phase") == "train"
        gt_path = self.paths[index]["gt_path"]
        lq_path = self.paths[index]["lq_path"]
        img_gt, img_lq = self._load_u8(gt_path, "gt"), self._load_u8(lq_path, "lq")

        plain = self.mean is None and self.std is None
        as_uint8 = self.opt.get("transfer_dtype") == "uint8" and train and scale == 1 and plain
        if (not as_uint8 and train and scale == 1 and plain and self.opt.get("use_native", True)
                and native.available()):
            gt_size = self.opt["gt_size"]
            if img_gt.shape[0] < gt_size or img_gt.shape[1] < gt_size:
                img_gt, img_lq = padding(img_gt, img_lq, gt_size)
            top = random.randint(0, img_gt.shape[0] - gt_size)
            left = random.randint(0, img_gt.shape[1] - gt_size)
            mode = random.randint(1, 7) if self.opt.get("geometric_augs") else 0
            img_gt, img_lq = native.paired_crop_augment(img_gt, img_lq, top, left, gt_size, mode)
            return {"lq": img_lq, "gt": img_gt, "lq_path": lq_path, "gt_path": gt_path}
        if as_uint8:
            gt_size = self.opt["gt_size"]
            if img_gt.shape[0] < gt_size or img_gt.shape[1] < gt_size:
                img_gt, img_lq = padding(img_gt, img_lq, gt_size)
        else:
            img_gt = img_gt.astype(np.float32) / 255.0
            img_lq = img_lq.astype(np.float32) / 255.0
            if train:
                img_gt, img_lq = padding(img_gt, img_lq, self.opt["gt_size"])
        if train:
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.opt["gt_size"], scale, gt_path)
            if self.opt.get("geometric_augs"):
                img_gt, img_lq = random_augmentation(img_gt, img_lq)

        # BGR -> RGB, HWC (the model's layout; no CHW transpose).
        img_gt = np.ascontiguousarray(img_gt[..., ::-1])
        img_lq = np.ascontiguousarray(img_lq[..., ::-1])
        if not as_uint8:
            img_gt, img_lq = _normalize(img_gt, self.mean, self.std), _normalize(img_lq, self.mean, self.std)
        return {"lq": img_lq, "gt": img_gt, "lq_path": lq_path, "gt_path": gt_path}


class SingleImageDataset:
    """LQ-only dataset for blind testing."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.file_client = None
        self.io_backend_opt = dict(opt.get("io_backend", {"type": "disk"}))
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        self.lq_folder = opt["dataroot_lq"]
        if self.io_backend_opt["type"] == "lmdb":
            self.io_backend_opt["db_paths"] = [self.lq_folder]
            self.io_backend_opt["client_keys"] = ["lq"]
            self.paths = paths_from_lmdb(self.lq_folder)
        elif opt.get("meta_info_file") is not None:
            import os

            with open(opt["meta_info_file"], "r") as fin:
                self.paths = [os.path.join(self.lq_folder, line.rstrip().split(" ")[0])
                              for line in fin]
        else:
            self.paths = paths_from_folder(self.lq_folder)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        if self.file_client is None:
            backend = dict(self.io_backend_opt)
            self.file_client = FileClient(backend.pop("type"), **backend)
        lq_path = self.paths[index]
        img_lq = imfrombytes(self.file_client.get(lq_path, "lq"), float32=True)
        img_lq = _normalize(np.ascontiguousarray(img_lq[..., ::-1], np.float32), self.mean, self.std)
        return {"lq": img_lq, "lq_path": lq_path}
