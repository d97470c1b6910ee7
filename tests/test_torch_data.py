"""The port's data layer and host utilities (`wavemamba_torch/data/`,
`utils/`) against wavemamba_tpu on the CPU.

Both packages read the same PNGs, written by a fixture, and draw their crops
and flips from python's `random` after the same seed: the arrays must be
equal, bit for bit (no arithmetic differs, only who runs it).
"""

import random
import time

import cv2
import numpy as np
import pytest
import torch

from wavemamba_torch import data as tdata
from wavemamba_torch.data import data_util as tdu
from wavemamba_torch.data import paired_image_dataset as tds
from wavemamba_torch.data import transforms as ttf
from wavemamba_torch.utils import file_client as tfc
from wavemamba_torch.utils import img_util as timg
from wavemamba_torch.utils import logger as tlog
from wavemamba_torch.utils import misc as tmisc
from wavemamba_torch.utils import registry as treg
from wavemamba_tpu.data import data_util as jdu
from wavemamba_tpu.data import loader as jloader
from wavemamba_tpu.data import paired_image_dataset as jds
from wavemamba_tpu.data import transforms as jtf
from wavemamba_tpu.utils import file_client as jfc
from wavemamba_tpu.utils import img_util as jimg
from wavemamba_tpu.utils import misc as jmisc

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)



@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Six 40x48 pairs and one 20x24 pair (smaller than the crop) as PNGs."""
    root = tmp_path_factory.mktemp("pairs")
    rs = np.random.RandomState(0)
    (root / "gt").mkdir()
    (root / "lq").mkdir()
    for i in range(7):
        shape = (20, 24, 3) if i == 6 else (40, 48, 3)
        gt = (rs.rand(*shape) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"{i:03d}.png"), gt)
        cv2.imwrite(str(root / "lq" / f"{i:03d}.png"), (gt * 0.3).astype(np.uint8))
    return root


def _opt(root, **kw):
    return {"name": "t", "type": "PairedImageDataset", "dataroot_gt": str(root / "gt"),
            "dataroot_lq": str(root / "lq"), "io_backend": {"type": "disk"}, "scale": 1,
            "use_native": False, **kw}


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("size,replicas,rank,ratio,epoch", [
    (10, 1, 0, 1, 0), (6, 1, 0, 8, 3), (7, 2, 1, 3, 1), (5, 4, 2, 2, 7)])
def test_enlarged_sampler_matches(size, replicas, rank, ratio, epoch):
    want = jloader.EnlargedSampler(size, replicas, rank, ratio)
    got = tdata.EnlargedSampler(size, replicas, rank, ratio)
    want.set_epoch(epoch)
    got.set_epoch(epoch)
    assert len(got) == len(want)
    assert list(got) == list(want)


@pytest.mark.parametrize("kw", [
    dict(phase="train", gt_size=32, geometric_augs=True),
    dict(phase="train", gt_size=32, geometric_augs=True, transfer_dtype="uint8"),
    dict(phase="train", gt_size=32, geometric_augs=False, cache_in_ram=True),
    dict(phase="train", gt_size=32, geometric_augs=True, mean=[0.5, 0.4, 0.3], std=[0.2, 0.3, 0.4]),
    dict(phase="val"),
    dict(phase="val", mean=[0.5, 0.5, 0.5]),
], ids=["train_f32", "train_uint8", "train_cached", "train_normalized", "val", "val_mean"])
def test_paired_dataset_matches(folders, kw):
    """Every item, the pair smaller than the crop included (reflect-padded),
    twice over (the second pass reads the RAM cache where it is on)."""
    want_ds, got_ds = jds.PairedImageDataset(_opt(folders, **kw)), tds.PairedImageDataset(_opt(folders, **kw))
    assert len(got_ds) == len(want_ds) == 7
    for seed in (1, 2):
        random.seed(seed)
        want = [want_ds[i] for i in range(7)]
        random.seed(seed)
        got = [got_ds[i] for i in range(7)]
        for g, w in zip(got, want):
            _assert_items_equal(g, w)
    if kw.get("transfer_dtype") == "uint8":
        assert got[0]["lq"].dtype == np.uint8 and got[0]["lq"].shape == (32, 32, 3)


def test_single_image_dataset_and_meta_info_match(folders, tmp_path):
    meta = tmp_path / "meta.txt"
    meta.write_text("002.png (40,48,3)\n000.png (40,48,3)\n")
    opt = {"dataroot_lq": str(folders / "lq"), "io_backend": {"type": "disk"}, "mean": [0.1] * 3}
    for extra in ({}, {"meta_info_file": str(meta)}):
        want, got = jds.SingleImageDataset({**opt, **extra}), tds.SingleImageDataset({**opt, **extra})
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    popt = _opt(folders, phase="val", meta_info_file=str(meta))
    want, got = jds.PairedImageDataset(popt), tds.PairedImageDataset(popt)
    assert got.paths == want.paths and len(got) == 2
    # The lmdb backend: JAX's refusal of folders not named .lmdb, JAX's pairs
    # from two `meta_info.txt`, and JAX's ImportError at the first item
    # (the `lmdb` package is not installed).
    for ds in (jds, tds):
        with pytest.raises(ValueError, match="lmdb formats"):
            ds.PairedImageDataset(_opt(folders, io_backend={"type": "lmdb"}))
    lmdb_root = tmp_path / "lmdb"
    for name in ("gt.lmdb", "lq.lmdb"):
        (lmdb_root / name).mkdir(parents=True)
        (lmdb_root / name / "meta_info.txt").write_text("001.png (40,48,3) 1\n000.png (40,48,3) 1\n")
    lopt = _opt(lmdb_root, phase="val", io_backend={"type": "lmdb"})
    lopt.update(dataroot_gt=str(lmdb_root / "gt.lmdb"), dataroot_lq=str(lmdb_root / "lq.lmdb"))
    sopt = {"dataroot_lq": lopt["dataroot_lq"], "io_backend": {"type": "lmdb"}}
    for make in (lambda ds: ds.PairedImageDataset(lopt), lambda ds: ds.SingleImageDataset(sopt)):
        want, got = make(jds), make(tds)
        assert got.paths == want.paths and got.io_backend_opt == want.io_backend_opt
        for ds in (want, got):
            with pytest.raises(ImportError, match="lmdb"):
                ds[0]


def test_build_dataset_and_threaded_loader_match(folders):
    """The loaders' batches, one worker each so that the crops are drawn in
    order: the same arrays and paths, epoch after epoch."""
    kw = dict(phase="train", gt_size=32, geometric_augs=True)
    want_ds, got_ds = jloader.build_dataset(_opt(folders, **kw)), tdata.build_dataset(_opt(folders, **kw))
    assert isinstance(got_ds, tds.PairedImageDataset)
    with pytest.raises(KeyError, match="Unknown dataset type"):
        tdata.build_dataset({"type": "VideoDataset"})
    args = dict(batch_size=3, num_workers=1, drop_last=True, seed=5)
    want_ld = jloader.ThreadedLoader(want_ds, sampler=jloader.EnlargedSampler(7, 1, 0, 2), **args)
    got_ld = tdata.ThreadedLoader(got_ds, sampler=tdata.EnlargedSampler(7, 1, 0, 2), **args)
    assert len(got_ld) == len(want_ld) == 4
    for epoch in (0, 1):
        want_ld.set_epoch(epoch)
        got_ld.set_epoch(epoch)
        random.seed(epoch)
        want = list(want_ld)
        random.seed(epoch)
        got = list(got_ld)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g["lq"].shape == (3, 32, 32, 3)
            _assert_items_equal(g, w)
    # No sampler: shuffled by seed + epoch, or in order.
    for shuffle in (True, False):
        w = jloader.ThreadedLoader(want_ds, batch_size=2, shuffle=shuffle, seed=3)._index_batches()
        g = tdata.ThreadedLoader(got_ds, batch_size=2, shuffle=shuffle, seed=3)._index_batches()
        assert g == w
    val = tdata.build_dataloader(got_ds, {"phase": "val"})
    assert val.batch_size == 1 and not val.shuffle and len(val) == 7
    train = tdata.build_dataloader(got_ds, {"phase": "train", "batch_size_per_gpu": 2}, seed=1)
    assert train.batch_size == 2 and train.shuffle and train.drop_last


def test_loader_surfaces_a_dataset_error_and_stops_early():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable image 5")
            return {"lq": np.full((2, 2, 3), i, np.float32)}

    with pytest.raises(OSError, match="unreadable image 5"):
        list(tdata.ThreadedLoader(Broken(), batch_size=2, num_workers=2))
    it = iter(tdata.ThreadedLoader(Broken(), batch_size=1, num_workers=1, prefetch=1))
    assert float(next(it)["lq"].max()) == 0.0
    it.close()  # an abandoned consumer must not leave the worker blocked


@pytest.mark.parametrize("mode", range(8))
def test_dihedral_modes_match(mode):
    img = np.random.RandomState(mode).rand(5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(ttf.data_augmentation(img, mode), jtf.data_augmentation(img, mode))


def test_transforms_match():
    rs = np.random.RandomState(0)
    gt, lq = rs.rand(24, 32, 3).astype(np.float32), rs.rand(12, 16, 3).astype(np.float32)
    for seed in range(4):
        random.seed(seed)
        want = jtf.paired_random_crop(gt, lq, 16, 2, "x.png")
        random.seed(seed)
        got = ttf.paired_random_crop(gt, lq, 16, 2, "x.png")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        random.seed(seed)
        want = jtf.random_augmentation(gt, lq) + list(jtf.augment([gt, lq], return_status=True)[0])
        random.seed(seed)
        got = ttf.random_augmentation(gt, lq) + list(ttf.augment([gt, lq], return_status=True)[0])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ttf.mod_crop(gt[:23, :31], 4), jtf.mod_crop(gt[:23, :31], 4))
    with pytest.raises(ValueError, match="Scale mismatches"):
        ttf.paired_random_crop(gt, lq, 16, 1)
    with pytest.raises(ValueError, match="smaller than patch size"):
        ttf.paired_random_crop(gt, lq, 64, 2)
    with pytest.raises(ValueError, match="Invalid choice"):
        ttf.data_augmentation(gt, 8)


def test_path_pairing_matches(folders, tmp_path):
    pair = [str(folders / "lq"), str(folders / "gt")]
    assert tdu.paired_paths_from_folder(pair, ["lq", "gt"]) == jdu.paired_paths_from_folder(pair, ["lq", "gt"])
    assert tdu.paths_from_folder(pair[0]) == jdu.paths_from_folder(pair[0])
    assert list(tmisc.scandir(pair[0], suffix=".png")) == list(jmisc.scandir(pair[0], suffix=".png"))
    meta = tmp_path / "m.txt"
    meta.write_text("001.png 1\n004.png 2\n")
    args = (pair, ["lq", "gt"], str(meta), "{}")
    assert tdu.paired_paths_from_meta_info_file(*args) == jdu.paired_paths_from_meta_info_file(*args)
    (tmp_path / "few").mkdir()
    with pytest.raises(ValueError, match="different number of images"):
        tdu.paired_paths_from_folder([str(tmp_path / "few"), pair[1]], ["lq", "gt"])


def test_image_io_matches(folders):
    path = str(folders / "gt" / "006.png")
    content = tfc.FileClient("disk").get(path)
    for kw in ({}, {"float32": True}, {"flag": "grayscale"}):
        np.testing.assert_array_equal(timg.imfrombytes(content, **kw), jimg.imfrombytes(content, **kw))
    np.testing.assert_array_equal(timg.imread(path), jimg.imread(path))
    small = timg.imread(path)  # 20x24
    for a, b in zip(timg.padding(small, small[..., ::-1], 32), jimg.padding(small, small[..., ::-1], 32)):
        assert a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
    assert timg.padding(small, small, 16)[0] is small
    batch = np.random.RandomState(0).rand(1, 6, 5, 3).astype(np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(timg.batch2img(batch), jimg.batch2img(batch))
    for fc in (tfc, jfc):  # the `lmdb` package is not installed: JAX's gate
        with pytest.raises(ImportError, match="lmdb"):
            fc.FileClient("lmdb", db_paths=["x.lmdb"])
    with pytest.raises(ValueError, match="not supported"):
        tfc.FileClient("ftp")
    assert "png" not in tfc.FileClient().get_text(__file__)[:20]


def _batches(n=5):
    for i in range(n):
        yield {"lq": np.full((2, 4, 4, 3), i, np.uint8), "gt": np.full((2, 4, 4, 3), i / 10, np.float32),
               "lq_path": [f"{i}a.png", f"{i}b.png"]}


def test_device_prefetch_on_the_cpu_keeps_order_and_types():
    got = list(tdata.device_prefetch(_batches(), device="cpu", depth=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["lq"], torch.Tensor) and b["lq"].dtype == torch.uint8
        assert b["gt"].dtype == torch.float32 and b["lq"].device.type == "cpu"
        assert int(b["lq"].max()) == i and b["lq"].shape == (2, 4, 4, 3)
        assert b["lq_path"] == [f"{i}a.png", f"{i}b.png"]
    it = tdata.device_prefetch(_batches(50), device="cpu", depth=1)
    assert int(next(it)["lq"].max()) == 0
    it.close()  # the worker ends with the consumer


def test_device_prefetch_surfaces_a_worker_error_and_needs_its_device(monkeypatch):
    def broken():
        yield from _batches(2)
        raise RuntimeError("loader died")

    it = tdata.device_prefetch(broken(), device="cpu")
    assert int(next(it)["lq"].max()) == 0 and int(next(it)["lq"].max()) == 1
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tdata.device_prefetch(_batches())  # at the call, before any batch is asked for


def test_registry():
    reg = treg.Registry("arch")

    @reg.register()
    def net_a():
        return "a"

    reg.register(len, name="length")
    assert reg.get("net_a")() == "a" and reg.get("length") is len
    assert "net_a" in reg and sorted(reg.keys()) == ["length", "net_a"]
    with pytest.raises(KeyError, match="already registered"):
        reg.register(net_a)
    with pytest.raises(KeyError, match="not found in registry 'arch'"):
        reg.get("net_b")
    assert treg.DATASET_REGISTRY._name == "dataset"


def test_misc_helpers_match(tmp_path):
    assert tmisc.sizeof_fmt(1536) == jmisc.sizeof_fmt(1536) == "1.5 KB"
    assert len(tmisc.get_time_str()) == len(jmisc.get_time_str()) == 15
    tmisc.set_random_seed(7)
    a = (random.random(), np.random.rand(), float(torch.rand(1)))
    tmisc.set_random_seed(7)
    assert a == (random.random(), np.random.rand(), float(torch.rand(1)))
    jmisc.set_random_seed(7)
    assert a[:2] == (random.random(), np.random.rand())

    root = tmp_path / "experiments" / "run"
    opt = {"is_train": True, "path": {
        "experiments_root": str(root), "models": str(root / "models"),
        "training_states": str(root / "training_states"), "log": str(root),
        "pretrain_network_g": str(tmp_path / "never_made"), "resume_state": None}}
    tmisc.make_exp_dirs(opt)
    assert (root / "models").is_dir() and (root / "training_states").is_dir()
    assert not (tmp_path / "never_made").exists()
    (root / "models" / "keep.pth").write_text("x")
    tmisc.make_exp_dirs(opt, archive=False)  # resuming: in place
    assert (root / "models" / "keep.pth").exists()
    tmisc.make_exp_dirs(opt)  # a fresh start archives what was there
    archived = [d for d in root.parent.iterdir() if "_archived_" in d.name]
    assert len(archived) == 1 and (archived[0] / "models" / "keep.pth").exists()
    assert not (root / "models" / "keep.pth").exists()

    ropt = {"network_g": {}, "path": {"resume_state": "s", "models": "m", "pretrain_network_g": "p"}}
    tmisc.check_resume(ropt, 300)
    assert ropt["path"]["pretrain_network_g"].replace("\\", "/") == "m/net_g_300.pth"
    untouched = {"network_g": {}, "path": {"resume_state": None, "pretrain_network_g": "p"}}
    tmisc.check_resume(untouched, 300)
    assert untouched["path"]["pretrain_network_g"] == "p"


def test_logger_helpers(tmp_path):
    timer = tlog.AvgTimer(window=2)
    for _ in range(3):
        time.sleep(0.002)
        timer.record()
    assert timer.get_current_time() > 0 and timer.get_avg_time() > 0 and timer.count == 0

    logger = tlog.get_root_logger()
    assert logger.name == "wavemamba_torch" and tlog.get_root_logger() is logger
    records = []

    class Keep(tlog.logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logger.addHandler(handler)
    try:
        opt = {"name": "tiny_run", "logger": {"print_freq": 1}, "train": {"total_iter": 10}}
        tlog.MessageLogger(opt, start_iter=1)(
            {"epoch": 2, "iter": 4, "lrs": [5e-4], "time": 0.25, "data_time": 0.05,
             "l1": 0.125, "total": 1.5})
    finally:
        logger.removeHandler(handler)
    assert len(records) == 1
    msg = records[0]
    assert msg.startswith("[tiny_..][epoch:  2, iter:       4, lr:(5.000e-04)] [eta: ")
    assert "time (data): 0.250 (0.050)] l1: 1.2500e-01 total: 1.5000e+00" in msg
    info = tlog.get_env_info()
    assert "wavemamba_torch" in info and f"torch: {torch.__version__}" in info and "cuda:" in info
    assert "jax" not in info
