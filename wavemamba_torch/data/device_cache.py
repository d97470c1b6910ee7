"""Device-resident training data: the whole uint8 dataset is staged on the
device once, and every batch is gathered, cropped and augmented there. The
counterpart of `wavemamba_tpu/data/device_cache.py`.

The per-step host work is a few random integers: the batch's indices (from
the sampler, or a permutation seeded by `seed + epoch`) and, from
`RandomState((seed + epoch) ^ 0x5EED)`, its crop offsets and dihedral modes
(1..7, or all 0 without `geometric_augs`), drawn in the JAX package's order,
so that both packages give the same batches bit for bit. The crop and the 8
dihedral augments match the host path's `paired_random_crop` +
`random_augmentation` (`data/transforms.py:data_augmentation`'s order of the
modes); the random streams are numpy's, not python's `random`.

With a mesh (`parallel.make_mesh()`, one process a rank), `batch_size` is
the global batch: every rank stages the whole dataset, draws the same global
batch from the same seed and an unsharded sampler, and keeps its rows
`[rank * b, (rank + 1) * b)`, b = batch_size / ranks. The ranks' slices
together are the JAX package's mesh batches (one process drawing the global
batch and sharding it over its devices), bit for bit. JAX refuses several
*processes* because its loader assembles one global array with
`jax.make_array_from_process_local_data`; here each rank keeps a tensor of
its own, so a process group is what the mesh variant runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from wavemamba_torch.device import resolve_device
from wavemamba_torch.parallel.mesh import axis_rank, axis_size
from wavemamba_torch.utils.file_client import FileClient
from wavemamba_torch.utils.img_util import imfrombytes
from wavemamba_torch.utils.profiler import annotate

# out[i, j] = img[rows, cols] of `transforms.data_augmentation(img, mode)` for
# a square image of side s: rows / cols are i or j (transposed where the mode
# turns by 90 or 270 degrees), flipped to s - 1 - (.) where the mode says so.
# Rows: transposed, rows flipped, columns flipped; columns: the mode.
_DIHEDRAL = ((0, 0, 1, 1, 0, 0, 1, 1),
             (0, 1, 0, 0, 1, 0, 1, 1),
             (0, 0, 1, 0, 1, 1, 0, 1))


def _dihedral_index(size, modes):
    """(rows, cols), each (B, size, size) int64 on `modes`' device, such that
    `img[b, rows[b], cols[b]]` is mode `modes[b]` of the square image
    `img[b]`."""
    dev = modes.device
    i = torch.arange(size, device=dev).view(1, size, 1).expand(len(modes), size, size)
    j = i.transpose(1, 2)
    transposed, flip_rows, flip_cols = torch.tensor(_DIHEDRAL, dtype=torch.bool,
                                                    device=dev)[:, modes].view(3, -1, 1, 1)
    rows, cols = torch.where(transposed, j, i), torch.where(transposed, i, j)
    rows = torch.where(flip_rows, size - 1 - rows, rows)
    cols = torch.where(flip_cols, size - 1 - cols, cols)
    return rows, cols


def _dihedral8(img, modes):
    """img: (B, s, s, C), modes: (B,) int in 0..7 -> each image under its
    mode of `transforms.data_augmentation` (0 identity, 1 flipud, 2 rot90, 3
    flipud(rot90), 4 rot180, 5 flipud(rot180), 6 rot270, 7 flipud(rot270)),
    as one gather."""
    rows, cols = _dihedral_index(img.shape[1], modes)
    batch = torch.arange(len(modes), device=img.device).view(-1, 1, 1)
    return img[batch, rows, cols]


def _crop(images, idx, tops, lefts, size):
    """images: (N, H, W, C) -> (B, size, size, C), image idx[b] from
    (tops[b], lefts[b]), as one gather."""
    span = torch.arange(size, device=images.device)
    return images[idx.view(-1, 1, 1), (tops.view(-1, 1) + span).view(-1, size, 1),
                  (lefts.view(-1, 1) + span).view(-1, 1, size)]


def _check_opt(opt):
    if opt.get("phase") != "train":
        raise ValueError("DeviceCachedLoader is train-phase only")
    if opt.get("mean") is not None or opt.get("std") is not None:
        raise ValueError("cache_on_device does not support mean/std")


def _shapes(images):
    """The set of image shapes of a list of HWC images or an (N, H, W, C) array."""
    return {images.shape[1:]} if isinstance(images, np.ndarray) else {im.shape for im in images}


class DeviceCachedLoader:
    """Drop-in for `ThreadedLoader` (train phase) yielding batches on the
    device: {'lq', 'gt'} uint8 NHWC RGB tensors on `device`, and their
    paths. `device_prefetch` is not needed (`yields_device_batches`): the
    train step takes uint8 batches on the device as they are.

    `DeviceCachedLoader(dataset, ...)` decodes a `PairedImageDataset`'s
    images with its own file client; `from_arrays` stages images already
    decoded (RGB uint8). Either raises `ValueError` where the data does not
    qualify (the JAX package's guards: train phase only, no mean / std,
    uniform 8-bit images at least the crop, within `budget_gb` GiB)."""

    yields_device_batches = True

    def __init__(self, dataset, batch_size, sampler=None, seed=None, device="cuda",
                 budget_gb=8.0, mesh=None):
        _check_opt(dataset.opt)
        backend = dict(dataset.io_backend_opt)
        client = FileClient(backend.pop("type"), **backend)
        # decoded BGR uint8 -> RGB, as the host uint8 path hands it on
        rgb = lambda path, key: np.ascontiguousarray(imfrombytes(client.get(path, key))[..., ::-1])
        lqs = [rgb(rec["lq_path"], "lq") for rec in dataset.paths]
        gts = [rgb(rec["gt_path"], "gt") for rec in dataset.paths]
        self._stage(lqs, gts, dataset.paths, dataset.opt, batch_size, sampler, seed, device,
                    budget_gb, mesh)

    @classmethod
    def from_arrays(cls, lq_all, gt_all, paths, opt, batch_size, sampler=None, seed=None,
                    device="cuda", budget_gb=8.0, mesh=None):
        """The loader over decoded RGB uint8 images: `lq_all`, `gt_all` lists
        of HWC arrays or (N, H, W, C) arrays, `paths` [{'lq_path', 'gt_path'}]
        one a pair, `opt` the dataset options (`phase`, `gt_size`, `scale`,
        `geometric_augs`, `mean` / `std`)."""
        _check_opt(opt)
        loader = cls.__new__(cls)
        loader._stage(lq_all, gt_all, paths, opt, batch_size, sampler, seed, device, budget_gb,
                      mesh)
        return loader

    def _stage(self, lqs, gts, paths, opt, batch_size, sampler, seed, device, budget_gb, mesh):
        self.batch_size = int(batch_size)
        self.ranks, self.rank = axis_size(mesh), axis_rank(mesh)
        if self.batch_size % self.ranks:
            raise ValueError(f"cache_on_device: global batch {self.batch_size} does not shard "
                             f"over {self.ranks} ranks")
        if self.ranks > 1 and getattr(sampler, "num_replicas", 1) != 1:
            raise ValueError("cache_on_device draws the global batch on every rank: give it an "
                             "unsharded sampler (EnlargedSampler(n, 1, 0, ratio))")
        self.sampler = sampler
        self.seed = 0 if seed is None else int(seed)
        self._epoch = 0
        self.gt_size = int(opt["gt_size"])
        self.scale = int(opt.get("scale", 1))
        self.geometric_augs = bool(opt.get("geometric_augs"))
        shapes_lq, shapes_gt = _shapes(lqs), _shapes(gts)
        if len(shapes_lq) != 1 or len(shapes_gt) != 1:
            raise ValueError(f"cache_on_device needs uniform image shapes, got "
                             f"lq={sorted(shapes_lq)} gt={sorted(shapes_gt)}")
        if not len(lqs) == len(gts) == len(paths):
            raise ValueError(f"cache_on_device: {len(lqs)} lq images, {len(gts)} gt images and "
                             f"{len(paths)} paths")
        lq_all, gt_all = (a if isinstance(a, np.ndarray) else np.stack(a) for a in (lqs, gts))
        if lq_all.dtype != np.uint8 or gt_all.dtype != np.uint8:
            raise ValueError("cache_on_device expects 8-bit images")
        h, w = lq_all.shape[1:3]
        lq_size = self.gt_size // self.scale
        if h < lq_size or w < lq_size:
            raise ValueError(f"images ({h},{w}) smaller than crop {self.gt_size}"
                             f"//{self.scale} — reflect-pad path is host-only")
        nbytes = lq_all.nbytes + gt_all.nbytes
        if nbytes > budget_gb * (1 << 30):
            raise ValueError(f"dataset {nbytes / 2**30:.2f} GiB exceeds the device cache "
                             f"budget {budget_gb} GiB")
        self.paths = list(paths)
        self.n = len(self.paths)
        self.crop_max_top, self.crop_max_left = h - lq_size, w - lq_size
        self.device = resolve_device(device)
        self.lq_all = torch.from_numpy(lq_all).to(self.device)
        self.gt_all = torch.from_numpy(gt_all).to(self.device)

    @property
    def nbytes(self):
        """Bytes of the staged images on the device."""
        return sum(t.numel() * t.element_size() for t in (self.lq_all, self.gt_all))

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else self.n
        return n // self.batch_size  # drop_last

    def set_epoch(self, epoch):
        self._epoch = int(epoch)
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def sample(self, idx, tops, lefts, modes):
        """The batch of images `idx` cropped at (`tops`, `lefts`) (the LQ
        grid; the GT's at `scale` times them) and, with `geometric_augs`,
        each pair under its dihedral mode: (lq, gt) uint8 on the device."""
        lq_size = self.gt_size // self.scale
        args = torch.from_numpy(np.stack([idx, tops, lefts, modes]).astype(np.int64))
        idx, tops, lefts, modes = args.to(self.device)  # one copy to the device
        lq = _crop(self.lq_all, idx, tops, lefts, lq_size)
        gt = _crop(self.gt_all, idx, tops * self.scale, lefts * self.scale, self.gt_size)
        if self.geometric_augs:
            lq, gt = _dihedral8(lq, modes), _dihedral8(gt, modes)
        return lq, gt

    def __iter__(self):
        if self.sampler is not None:
            indices = np.asarray(list(iter(self.sampler)), np.int64)
        else:
            indices = np.random.RandomState(self.seed + self._epoch).permutation(self.n)
        rng = np.random.RandomState((self.seed + self._epoch) ^ 0x5EED)
        local = self.batch_size // self.ranks
        rows = slice(self.rank * local, (self.rank + 1) * local)  # this rank's share
        for b in range(len(indices) // self.batch_size):
            # closed before the yield: a span open across it would time the consumer
            with annotate("wm.data.batch"):
                idx = indices[b * self.batch_size:(b + 1) * self.batch_size]
                tops = rng.randint(0, self.crop_max_top + 1, size=self.batch_size)
                lefts = rng.randint(0, self.crop_max_left + 1, size=self.batch_size)
                # random_augmentation picks a mode in 1..7 (transforms.py)
                modes = (rng.randint(1, 8, size=self.batch_size) if self.geometric_augs
                         else np.zeros(self.batch_size, np.int64))
                idx, tops, lefts, modes = (a[rows] for a in (idx, tops, lefts, modes))
                lq, gt = self.sample(idx, tops, lefts, modes)
            yield {"lq": lq, "gt": gt,
                   "lq_path": [self.paths[i]["lq_path"] for i in idx],
                   "gt_path": [self.paths[i]["gt_path"] for i in idx]}
