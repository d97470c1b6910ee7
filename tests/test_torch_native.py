"""The port's native crop (`wavemamba_torch/data/native.py`, built from
`native/wavedata.cc` into `build/wavemamba_torch/`) against the JAX
package's binding of the same source, its numpy versions, and the dataset's
native route against JAX's, on the CPU.

Bit for bit throughout: both bindings run one C++ pass, its numpy version
multiplies by the same float32 1/255, and both datasets draw the crop and
the mode from `random` in one order. The dataset's numpy route divides by
255 instead: within a float32 rounding (2^-24 below 1) of the native items.
"""

import random

import cv2
import numpy as np
import pytest
import torch

from wavemamba_torch.data import native as tnat
from wavemamba_torch.data import paired_image_dataset as tds
from wavemamba_tpu.data import native as jnat
from wavemamba_tpu.data import paired_image_dataset as jds
from wavemamba_tpu.data.transforms import data_augmentation

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)


def _pairs(n, shapes, seed):
    rs = np.random.RandomState(seed)
    gts = [rs.randint(0, 256, (*shapes[i % len(shapes)], 3)).astype(np.uint8) for i in range(n)]
    return gts, [(g // 3).astype(np.uint8) for g in gts]


def test_the_library_builds_from_the_source_into_build():
    """`native/wavedata.cc` -> `build/wavemamba_torch/libwavedata_<hash>.so`,
    named by the source, `native/build.sh`'s flags and the CPU; never into
    `native/`."""
    path = tnat.build()
    assert path.parent == tnat.ROOT / "build" / "wavemamba_torch"
    assert path.name.startswith("libwavedata_") and path.suffix == ".so"
    assert tnat.SOURCE == tnat.ROOT / "native" / "wavedata.cc"
    assert tnat.build() == path  # made once
    assert tnat.available()
    with open(tnat.ROOT / "native" / "build.sh") as f:
        assert " ".join(tnat.CXX_FLAGS) in f.read()


@pytest.mark.parametrize("mode", range(8))
def test_crop_augment_matches_jax_and_numpy(mode):
    """Each dihedral mode, with and without the channel swap: the port's
    binding, JAX's and the numpy version give the same bits; the numpy route
    of `transforms.data_augmentation` / 255 within a float32 rounding."""
    gt, lq = (p[0] for p in _pairs(1, [(24, 30)], mode))
    top, left, size = 3, 5, 16
    for bgr2rgb in (True, False):
        got = tnat.paired_crop_augment(gt, lq, top, left, size, mode, bgr2rgb)
        want = jnat.paired_crop_augment(gt, lq, top, left, size, mode, bgr2rgb)
        plain = tnat.paired_crop_augment_plain(gt, lq, top, left, size, mode, bgr2rgb)
        for g, w, p in zip(got, want, plain):
            assert g.dtype == np.float32 and g.shape == (size, size, 3)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
    ref = data_augmentation(gt[top:top + size, left:left + size], mode)[..., ::-1].astype(np.float32) / 255.0
    np.testing.assert_allclose(tnat.paired_crop_augment(gt, lq, top, left, size, mode)[0], ref,
                               rtol=0, atol=2.0 ** -24)


def test_crop_augment_refuses_what_the_pass_would_read_past():
    gt, lq = (p[0] for p in _pairs(1, [(24, 30)], 0))
    for args in ((10, 0, 16, 0), (0, 15, 16, 0), (0, 0, 16, 8)):
        with pytest.raises(ValueError):
            tnat.paired_crop_augment(gt, lq, *args)
    with pytest.raises(ValueError, match="uint8"):
        tnat.paired_crop_augment(gt.astype(np.float32), lq, 0, 0, 16, 0)


@pytest.mark.parametrize("geometric", [True, False])
def test_batch_is_deterministic_across_threads_and_matches_jax(geometric):
    """The same batch on 1, 3 and all threads; JAX's binding's bits; the
    numpy version at `batch_draws`' crops and modes; another seed differs."""
    gts, lqs = _pairs(6, [(40, 44), (33, 50), (16, 16)], 1)
    runs = [tnat.batch_paired_crop_augment(gts, lqs, 16, seed=7, geometric=geometric, n_threads=n)
            for n in (1, 3, 0)]
    want = jnat.batch_paired_crop_augment(gts, lqs, 16, seed=7, geometric=geometric, n_threads=2)
    for run in runs:
        for g, w in zip(run, want):
            np.testing.assert_array_equal(g, w)
    draws = tnat.batch_draws([g.shape[0] for g in gts], [g.shape[1] for g in gts], 16, 7, geometric)
    assert {m for _, _, m in draws} <= (set(range(1, 8)) if geometric else {0})
    for i, (top, left, mode) in enumerate(draws):
        plain = tnat.paired_crop_augment_plain(gts[i], lqs[i], top, left, 16, mode)
        np.testing.assert_array_equal(runs[0][0][i], plain[0])
        np.testing.assert_array_equal(runs[0][1][i], plain[1])
    assert not np.array_equal(tnat.batch_paired_crop_augment(gts, lqs, 16, seed=8)[0], runs[0][0])


def test_to_float_rgb_matches_jax():
    img = _pairs(1, [(10, 12)], 2)[0][0]
    np.testing.assert_array_equal(tnat.to_float_rgb(img), jnat.to_float_rgb(img))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """PNG pairs, one smaller than the crop (the reflect padding's case)."""
    root = tmp_path_factory.mktemp("native_pairs")
    rs = np.random.RandomState(3)
    for sub in ("gt", "lq"):
        (root / sub).mkdir()
    for i, (h, w) in enumerate([(40, 48), (36, 52), (20, 24), (44, 40)]):
        gt = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"{i:03d}.png"), gt)
        cv2.imwrite(str(root / "lq" / f"{i:03d}.png"), (gt // 4).astype(np.uint8))
    return root


def _opt(folders, **kw):
    return {"dataroot_gt": str(folders / "gt"), "dataroot_lq": str(folders / "lq"),
            "io_backend": {"type": "disk"}, "phase": "train", "gt_size": 32, **kw}


def _items(ds, seed, epochs=2):
    random.seed(seed)
    return [ds[i] for _ in range(epochs) for i in range(len(ds))]


@pytest.mark.parametrize("geometric_augs", [True, False])
def test_the_dataset_takes_the_native_route_where_jax_does(folders, monkeypatch, geometric_augs):
    """Train phase, scale 1, no mean / std: both datasets crop by the native
    pass, drawing (top, left, mode) in one order: the same items, bit for
    bit. The port's native route is taken (counted), and its items match
    the numpy route's (`use_native: false`) within a float32 rounding."""
    opt = _opt(folders, geometric_augs=geometric_augs)
    calls = []
    crop = tnat.paired_crop_augment
    monkeypatch.setattr(tnat, "paired_crop_augment", lambda *a, **k: calls.append(a[2:]) or crop(*a, **k))
    got = _items(tds.PairedImageDataset(opt), 11)
    want = _items(jds.PairedImageDataset(opt), 11)
    numpy_route = _items(tds.PairedImageDataset({**opt, "use_native": False}), 11)
    assert len(calls) == len(got) == 8
    for g, w, n in zip(got, want, numpy_route):
        assert g["lq_path"] == w["lq_path"] and g["gt"].dtype == np.float32
        assert g["gt"].shape == (32, 32, 3)
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_allclose(g[k], n[k], rtol=0, atol=2.0 ** -24)


@pytest.mark.parametrize("kw", [{"transfer_dtype": "uint8"}, {"mean": [0.5] * 3}, {"phase": "val"},
                                {"use_native": False}])
def test_the_native_route_is_skipped_where_jax_skips_it(folders, monkeypatch, kw):
    """The uint8 route, mean / std, a val phase and `use_native: false` take
    the numpy route in both packages: no native call, JAX's items."""
    monkeypatch.setattr(tnat, "paired_crop_augment", lambda *a, **k: pytest.fail("native route"))
    opt = _opt(folders, geometric_augs=True, **kw)
    got, want = _items(tds.PairedImageDataset(opt), 12, 1), _items(jds.PairedImageDataset(opt), 12, 1)
    for g, w in zip(got, want):
        for k in ("lq", "gt"):
            np.testing.assert_array_equal(g[k], w[k])


def test_a_failed_build_takes_the_numpy_route(folders, monkeypatch):
    """Where g++ fails, `available()` is False and the dataset takes the
    numpy route, as JAX's does without its library: JAX's numpy items."""
    def fail():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(tnat, "build", fail)
    tnat._load.cache_clear()
    try:
        assert not tnat.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            tnat.paired_crop_augment(*_pairs(1, [(20, 20)], 0), 0, 0, 16, 0)
        opt = _opt(folders, geometric_augs=True)
        got = _items(tds.PairedImageDataset(opt), 13)
        want = _items(jds.PairedImageDataset({**opt, "use_native": False}), 13)
        for g, w in zip(got, want):
            for k in ("lq", "gt"):
                np.testing.assert_array_equal(g[k], w[k])
    finally:
        tnat._load.cache_clear()
