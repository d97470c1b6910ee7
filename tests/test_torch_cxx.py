"""The port's native boundary (`wavemamba_torch/utils/cxx.py`) and its one
bottom/right reflect pad (`models/buckets.py:pad_to_shape`), on the CPU:
every device library's loader refuses a host without CUDA by the kernel's
name, `build_all` builds every `csrc/*.cu` on disk into the directory
`set_build_dir` names (a stand-in for nvcc), and the pad gives numpy's
reflect bits for arrays and tensors, narrow pads and wide ones."""

import numpy as np
import pytest
import torch

from wavemamba_torch.models.buckets import pad_to_shape
from wavemamba_torch.ops import art_attention, conv_fused_cuda, scan_cuda
from wavemamba_torch.scripts import gpu_probe
from wavemamba_torch.utils import cxx

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

LOADERS = {"K1": scan_cuda._library, "K2": scan_cuda._library_bwd, "K3": scan_cuda._library_k3,
           "K4": scan_cuda._library_k4, "K5": scan_cuda._library_k5,
           "K6 / K7 conv-chain": conv_fused_cuda._library,
           "ART attention": art_attention._library, "P1-P5 probe": gpu_probe._library}


@pytest.mark.parametrize("kernel", LOADERS)
def test_device_library_needs_a_card(kernel, monkeypatch):
    """Without CUDA a kernel's loader raises, naming the kernel, before it
    builds anything: nothing falls back to a plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_build(*args, **kw):
        raise AssertionError("built without a card")

    monkeypatch.setattr(cxx, "build", no_build)
    with pytest.raises(RuntimeError, match=f"the {kernel} kernel needs a CUDA device"):
        LOADERS[kernel].__wrapped__()


def test_build_all_builds_every_source_into_the_build_directory(tmp_path, monkeypatch):
    """`build_all` builds each `csrc/*.cu` found on disk, ART's attention
    with the rest, once each, into the directory `set_build_dir` names, each
    with its compiler report beside it; the sources the kernel modules name
    are among them."""
    monkeypatch.setattr(cxx, "BUILD_DIR", cxx.BUILD_DIR)
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd[-1])
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return type("Done", (), {"returncode": 0, "stdout": "ptxas info", "stderr": ""})()

    monkeypatch.setattr(cxx, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cxx.subprocess, "run", fake_nvcc)
    out = cxx.set_build_dir(tmp_path / "kernels")
    libs = cxx.build_all()
    names = sorted(p.name for p in cxx.CSRC.glob("*.cu"))
    assert sorted(libs) == names and "art_attention.cu" in names
    assert sorted(runs) == sorted(str(cxx.CSRC / n) for n in names)
    for name, lib in libs.items():
        assert lib.parent == out and lib.name.startswith(name.removesuffix(".cu") + "_")
        assert lib.with_suffix(".log").read_text() == "ptxas info"
    for source in (scan_cuda.SOURCE, scan_cuda.SOURCE_BWD, scan_cuda.SOURCE_K3, scan_cuda.SOURCE_K4,
                   scan_cuda.SOURCE_K5, conv_fused_cuda.SOURCE, art_attention.SOURCE,
                   gpu_probe.SOURCE):
        assert libs[source.name] == cxx.build(source)
    assert len(runs) == len(names)  # every later build finds its library


@pytest.mark.parametrize("shape", [(13, 10), (3, 2), (32, 16)], ids=["narrow", "wide", "none"])
@pytest.mark.parametrize("kind", ["array", "tensor"])
def test_pad_to_shape_is_numpy_reflect(kind, shape):
    """`pad_to_shape` to at least 16x16 equals `np.pad(mode="reflect")` bit for bit:
    a pad narrower than the image (a tensor's on its device by `F.pad`), one
    wider (numpy re-reflects), and none (x itself)."""
    h, w = shape
    x = np.random.RandomState(h * w).rand(2, h, w, 3).astype(np.float32)
    H, W = max(h, 16), max(w, 16)
    want = np.pad(x, ((0, 0), (0, H - h), (0, W - w), (0, 0)), mode="reflect")
    got = pad_to_shape(torch.from_numpy(x) if kind == "tensor" else x, H, W)
    assert type(got) is (torch.Tensor if kind == "tensor" else np.ndarray)
    np.testing.assert_array_equal(np.asarray(got), want)
