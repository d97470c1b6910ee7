"""The port's download helper and profiler (`wavemamba_torch/utils/
download_util.py`, `utils/profiler.py`) on the CPU, beside the JAX package's.

The download tests never reach the network: a cached file is returned as
it is, and a miss goes through `urlretrieve`, which each test replaces.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from wavemamba_torch.utils import download_util as tdl
from wavemamba_torch.utils import profiler as tprof
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
