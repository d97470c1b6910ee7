"""The port's download helper and profiler (`wavemamba_torch/utils/
download_util.py`, `utils/profiler.py`), and its inverse colour conversions
and `crop_border` (`utils/color.py`, `utils/img_util.py`), on the CPU, beside
the JAX package's.

The download tests never reach the network: a cached file is returned as
it is, and a miss goes through `urlretrieve`, which each test replaces.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import wavemamba_torch.utils as tutils
import wavemamba_tpu.utils as jutils
from wavemamba_torch.utils import download_util as tdl
from wavemamba_torch.utils import profiler as tprof
from wavemamba_tpu.utils import color as jcolor
from wavemamba_tpu.utils import download_util as jdl

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

URL = "https://example.invalid/weights/vgg19-dcbb9e9d.pth"


def _refuse(*args, **kwargs):
    raise OSError("network is not reachable")


def test_cached_file_is_returned_without_a_fetch(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve", _refuse)
    (tmp_path / "vgg19-dcbb9e9d.pth").write_bytes(b"weights")
    got = tdl.load_file_from_url(URL, model_dir=str(tmp_path))
    assert got == str(tmp_path / "vgg19-dcbb9e9d.pth")
    assert got == jdl.load_file_from_url(URL, model_dir=str(tmp_path))
    named = tdl.load_file_from_url(URL, model_dir=str(tmp_path), file_name="vgg19-dcbb9e9d.pth")
    assert named == got


def test_miss_with_a_failed_fetch_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve", _refuse)
    with pytest.raises(FileNotFoundError, match="not in the local weights cache"):
        tdl.load_file_from_url(URL, model_dir=str(tmp_path / "cache"))
    assert os.path.isdir(tmp_path / "cache")


def test_miss_is_fetched_into_the_cache(tmp_path, monkeypatch):
    calls = []

    def fetch(url, dest):
        calls.append(url)
        with open(dest, "wb") as f:
            f.write(b"fetched")

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    got = tdl.load_file_from_url(URL, model_dir=str(tmp_path))
    assert calls == [URL] and open(got, "rb").read() == b"fetched"
    tdl.load_file_from_url(URL, model_dir=str(tmp_path))
    assert calls == [URL]  # the second call finds the cached file


def test_weights_dir_env_and_default(monkeypatch, tmp_path):
    monkeypatch.setenv("WM_WEIGHTS_DIR", str(tmp_path))
    assert tdl.weights_dir() == jdl.weights_dir() == str(tmp_path)
    monkeypatch.delenv("WM_WEIGHTS_DIR")
    assert tdl.weights_dir().endswith(os.path.join(".cache", "wavemamba_torch"))
    assert tdl.sizeof_fmt(3 * 1024**2) == jdl.sizeof_fmt(3 * 1024**2) == "3.0 MB"


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / "traces"
    with tprof.trace(str(log_dir)):
        with tprof.annotate("wm_region"):
            torch.nn.functional.conv2d(torch.rand(1, 3, 16, 16), torch.rand(4, 3, 3, 3))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "wm_region" in names and any("conv" in str(n) for n in names)


def test_step_timer_counts_steps():
    timer = tprof.StepTimer()
    fenced = []
    for i in range(3):
        with timer.step(lambda: fenced.append(i) or {"y": torch.ones(2)}):
            torch.rand(8).sum()
    assert fenced == [0, 1, 2] and len(timer.times) == 3
    with timer.step():
        pass
    s = timer.summary()
    assert s["n"] == 4 and s["min_s"] >= 0 and np.isfinite(s["mean_s"]) and s["p50_s"] >= s["min_s"]


@pytest.mark.parametrize("name", ["ycbcr2rgb", "ycbcr2bgr"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_inverse_colour_conversions_match_jax(name, dtype):
    """`ycbcr2rgb` / `ycbcr2bgr` on seeded HWC images against the JAX
    package's: the same numpy arithmetic, so the same bits (uint8 in gives
    uint8, float [0, 1] gives float32); a float round trip through
    `rgb2ycbcr` comes back within 1e-3 (MATLAB's constants have 6 digits)."""
    rs = np.random.RandomState(7)
    img = rs.randint(0, 256, (17, 23, 3), np.uint8)
    if dtype == np.float32:
        img = (img / 255.0).astype(np.float32)
    got = getattr(tutils, name)(img)
    want = getattr(jcolor, name)(img)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "ycbcr2rgb" and dtype == np.float32:
        from wavemamba_torch.utils.color import rgb2ycbcr

        assert np.abs(tutils.ycbcr2rgb(rgb2ycbcr(img)) - img).max() <= 1e-3


@pytest.mark.parametrize("crop", [0, 3])
def test_crop_border_matches_jax(crop):
    """`crop_border` of one image and of a list, uint8 and float32, equals
    JAX's (exported from `utils` in both packages)."""
    rs = np.random.RandomState(crop)
    imgs = [rs.randint(0, 256, (20, 16, 3), np.uint8), rs.rand(20, 16, 1).astype(np.float32)]
    for got, want in zip(tutils.crop_border(imgs, crop), jutils.crop_border(imgs, crop)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tutils.crop_border(imgs[0], crop),
                                  jutils.crop_border(imgs[0], crop))
    assert tutils.crop_border(imgs[0], crop).shape == (20 - 2 * crop, 16 - 2 * crop, 3)
