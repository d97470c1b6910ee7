"""The device-resident dataset (`wavemamba_torch/data/device_cache.py`)
against the JAX package's (`wavemamba_tpu/data/device_cache.py`) on the CPU:
the same seeded PNG folder, seed and sampler give the same batches bit for
bit; the dihedral modes, the scale-2 crop and the guards are JAX's; and
`pipelines.train` trains from it where `cache_on_device: true`.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wavemamba_torch.data import DeviceCachedLoader, EnlargedSampler
from wavemamba_torch.data.device_cache import _dihedral8
from wavemamba_torch.data.paired_image_dataset import PairedImageDataset
from wavemamba_tpu.data import device_cache as jcache
from wavemamba_tpu.data.loader import EnlargedSampler as JaxEnlargedSampler
from wavemamba_tpu.data.paired_image_dataset import PairedImageDataset as JaxPairedImageDataset
from wavemamba_tpu.data.transforms import data_augmentation

cv2 = pytest.importorskip("cv2")

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


def _write_dataset(root, n=8, size=24, lq_size=None):
    """`tests/test_device_cache.py:_write_dataset`: n seeded PNG pairs."""
    rng = np.random.RandomState(3)
    (root / "gt").mkdir(parents=True)
    (root / "input").mkdir(parents=True)
    for i in range(n):
        gt = rng.randint(0, 256, (size, size, 3), np.uint8)
        lq = (rng.randint(0, 256, (lq_size, lq_size, 3), np.uint8) if lq_size
              else (gt // 2).astype(np.uint8))
        cv2.imwrite(str(root / "gt" / f"{i:03d}.png"), gt)
        cv2.imwrite(str(root / "input" / f"{i:03d}.png"), lq)


def _opt(root, **extra):
    return {"phase": "train", "dataroot_gt": str(root / "gt"), "dataroot_lq": str(root / "input"),
            "io_backend": {"type": "disk"}, "gt_size": 16, "scale": 1, "geometric_augs": True,
            **extra}


def _loaders(root, batch_size, seed, sampler, **extra):
    """The port's loader (on CPU tensors) and JAX's over the same folder."""
    port_sampler = jax_sampler = None
    if sampler:
        n = len(PairedImageDataset(_opt(root, **extra)).paths)
        port_sampler, jax_sampler = EnlargedSampler(n, 1, 0, 2), JaxEnlargedSampler(n, 1, 0, 2)
    port = DeviceCachedLoader(PairedImageDataset(_opt(root, **extra)), batch_size,
                              sampler=port_sampler, seed=seed, device="cpu")
    ref = jcache.DeviceCachedLoader(JaxPairedImageDataset(_opt(root, **extra)), batch_size,
                                    sampler=jax_sampler, seed=seed)
    return port, ref


@pytest.mark.parametrize("sampler,augs,epoch", [(True, True, 0), (False, True, 1),
                                                (True, False, 2)])
def test_one_epoch_matches_jax(tmp_path, sampler, augs, epoch):
    """Every batch of one epoch: lq, gt and paths equal JAX's, bit for bit."""
    _write_dataset(tmp_path, n=10, size=24)
    port, ref = _loaders(tmp_path, 4, 7, sampler, geometric_augs=augs)
    assert port.yields_device_batches and len(port) == len(ref) == (5 if sampler else 2)
    assert port.nbytes == 2 * 10 * 24 * 24 * 3
    port.set_epoch(epoch)
    ref.set_epoch(epoch)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(port)
    for g, w in zip(got, want):
        assert g["lq"].dtype == torch.uint8 and g["lq"].shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(g["lq"].numpy(), np.asarray(w["lq"]))
        np.testing.assert_array_equal(g["gt"].numpy(), np.asarray(w["gt"]))
        assert (g["lq_path"], g["gt_path"]) == (w["lq_path"], w["gt_path"])


@pytest.mark.parametrize("mode", range(8))
def test_dihedral8_matches_jax(mode):
    """On a 5x5 square crop of distinct pixel values: JAX's `_dihedral8` and
    the host path's `data_augmentation` (numpy)."""
    img = np.arange(5 * 5 * 3, dtype=np.uint8).reshape(5, 5, 3)
    got = _dihedral8(torch.from_numpy(np.stack([img, img[::-1].copy()])),
                     torch.tensor([mode, mode])).numpy()
    for g, im in zip(got, (img, img[::-1])):
        np.testing.assert_array_equal(g, np.asarray(jcache._dihedral8(jnp.asarray(im), mode)))
        np.testing.assert_array_equal(g, data_augmentation(im, mode))


def test_scale2_crop_alignment(tmp_path):
    """`tests/test_device_cache.py:test_scale2_crop_alignment`: the GT crop
    at twice the LQ offsets, under the pair's mode, as JAX's `_sample`."""
    _write_dataset(tmp_path, n=4, size=24, lq_size=12)
    port, ref = _loaders(tmp_path, 2, 0, False, gt_size=8, scale=2)
    idx, tops, lefts, modes = ([1, 2], [3, 0], [0, 5], [2, 6])
    lq, gt = port.sample(*map(np.asarray, (idx, tops, lefts, modes)))
    assert lq.shape == (2, 4, 4, 3) and gt.shape == (2, 8, 8, 3)
    gt_all = port.gt_all.numpy()
    for b in range(2):
        crop = gt_all[idx[b], 2 * tops[b]:2 * tops[b] + 8, 2 * lefts[b]:2 * lefts[b] + 8]
        np.testing.assert_array_equal(gt[b].numpy(), data_augmentation(crop, modes[b]))
    want = ref._sample(ref.lq_all, ref.gt_all, *(np.asarray(v, np.int32)
                                                  for v in (idx, tops, lefts, modes)))
    np.testing.assert_array_equal(lq.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(want[1]))


# The dataset options that hit each guard a PNG folder can reach ('budget'
# passes a tiny budget, 'uniform' writes one GT image of another size).
GUARDS = {"phase": dict(phase="val"), "mean/std": dict(mean=[0.5, 0.5, 0.5]),
          "crop": dict(gt_size=32), "budget": {}, "uniform": {}}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_guards_raise_jax_errors(tmp_path, guard):
    """Each guard raises the JAX package's `ValueError`, word for word."""
    _write_dataset(tmp_path, n=4, size=24)
    extra = GUARDS[guard]
    if guard == "uniform":
        cv2.imwrite(str(tmp_path / "gt" / "003.png"), np.zeros((30, 30, 3), np.uint8))
    budget = 1e-6 if guard == "budget" else 8.0
    errors = []
    for dataset, loader, kw in ((PairedImageDataset, DeviceCachedLoader, {"device": "cpu"}),
                                (JaxPairedImageDataset, jcache.DeviceCachedLoader, {})):
        with pytest.raises(ValueError) as caught:
            loader(dataset(_opt(tmp_path, **extra)), 2, budget_gb=budget, **kw)
        errors.append(str(caught.value))
    assert errors[0] == errors[1]


def test_from_arrays_stages_decoded_images_and_refuses_other_dtypes():
    """`from_arrays` takes (N, H, W, C) uint8 arrays without decoding, as the
    dataset path stages them, and refuses other dtypes by JAX's message."""
    rs = np.random.RandomState(0)
    lq, gt = (rs.randint(0, 256, (3, 20, 20, 3)).astype(np.uint8) for _ in range(2))
    paths = [{"lq_path": f"lq/{i}", "gt_path": f"gt/{i}"} for i in range(3)]
    opt = {"phase": "train", "gt_size": 16, "geometric_augs": True}
    loader = DeviceCachedLoader.from_arrays(lq, gt, paths, opt, 2, seed=3, device="cpu")
    assert torch.equal(loader.lq_all, torch.from_numpy(lq)) and len(loader) == 1
    batch = next(iter(loader))
    assert batch["lq"].shape == (2, 16, 16, 3) and len(batch["gt_path"]) == 2
    with pytest.raises(ValueError, match="cache_on_device expects 8-bit images"):
        DeviceCachedLoader.from_arrays(lq.astype(np.uint16), gt, paths, opt, 2, device="cpu")
    with pytest.raises(ValueError, match="3 lq images, 3 gt images and 2 paths"):
        DeviceCachedLoader.from_arrays(lq, gt, paths[:2], opt, 2, device="cpu")


def test_train_pipeline_with_device_cache(tmp_path, monkeypatch):
    """`tests/test_device_cache.py:test_train_pipeline_with_device_cache`:
    `cache_on_device: true` engages inside `train_pipeline` (no host-loader
    fallback, no host staging thread) and it trains and checkpoints."""
    from wavemamba_torch.pipelines import train as ttrain_pipeline

    def no_staging(*args, **kwargs):
        raise AssertionError("device batches went through device_prefetch")

    monkeypatch.setattr(ttrain_pipeline, "device_prefetch", no_staging)
    root = tmp_path / "data"
    _write_dataset(root, n=8, size=40)
    opt = {
        "name": "tiny_devcache", "model_type": "FeMaSRModel", "scale": 1, "manual_seed": 0,
        "datasets": {"train": {
            "name": "t", "type": "PairedImageDataset", "dataroot_gt": str(root / "gt"),
            "dataroot_lq": str(root / "input"), "io_backend": {"type": "disk"}, "gt_size": 32,
            "geometric_augs": True, "batch_size_per_gpu": 2, "dataset_enlarge_ratio": 1,
            "cache_on_device": True}},
        "network_g": {"type": "WaveMamba", "in_chn": 3, "wf": 8, "n_l_blocks": [1, 1, 1],
                      "n_h_blocks": [1, 1, 1], "ffn_scale": 2.0, "scan_chunk": 16},
        "path": {"pretrain_network_g": None, "resume_state": None},
        "train": {"optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-3,
                              "betas": [0.9, 0.99]},
                  "scheduler": {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 100],
                                "restart_weights": [1, 1], "eta_mins": [1e-3, 1e-7]},
                  "total_iter": 4, "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}},
        "logger": {"print_freq": 2, "save_checkpoint_freq": 4, "use_tb_logger": False},
    }
    opt_path = tmp_path / "opt.yml"
    opt_path.write_text(yaml.safe_dump(opt))
    # The package's logger keeps the file of the first pipeline its process
    # ran, so read what it logs here from a handler of this test's own.
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("wavemamba_torch")
    logger.addHandler(handler)
    try:
        model = ttrain_pipeline.train_pipeline(str(tmp_path), args=["-opt", str(opt_path),
                                                                    "--device", "cpu"])
    finally:
        logger.removeHandler(handler)
    assert model.state.step == 4
    assert model.model.cfg.remat and model.model.cfg.remat_policy == "save_scan"
    assert (tmp_path / "experiments" / "tiny_devcache" / "models" / "net_g_latest.pth").exists()
    assert any("cache_on_device: dataset staged on cpu" in ln for ln in lines), lines
    assert not any("cache_on_device unavailable" in ln for ln in lines)
