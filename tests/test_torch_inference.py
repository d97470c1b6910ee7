"""The port's inference CLI (`python -m wavemamba_torch.inference`) and its
host-side pieces against the JAX package on the CPU.

The CLI test runs both CLIs on one folder of two small PNGs with a GT folder.
The weights are a small-width `.pth` written by the JAX package's exporter
from a seeded init. Output PNGs agree within one uint8 level; PSNR within
1e-3 dB, SSIM within 1e-4; both open the same number of buckets.
"""

import os
import re

import cv2
import jax
import numpy as np
import pytest
import torch

from wavemamba_torch import inference as tinf
from wavemamba_torch.metrics import build_metric as t_build_metric
from wavemamba_torch.models import buckets as tbuckets
from wavemamba_torch.utils import color as tcolor
from wavemamba_torch.utils import img_util as timg
from wavemamba_torch.utils.misc import scandir as t_scandir
from wavemamba_tpu.metrics import build_metric as j_build_metric
from wavemamba_tpu.models import buckets as jbuckets
from wavemamba_tpu.utils import color as jcolor
from wavemamba_tpu.utils import img_util as jimg
from wavemamba_tpu.utils.misc import scandir as j_scandir

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


SIZE_FLAGS = ["--wf", "8", "--n_l_blocks", "1", "1", "1", "--n_h_blocks", "1", "1", "1"]
LINE = re.compile(r"^(\S+): [\d.]+s  psnr ([\d.]+)  ssim ([\d.]+)$")


def _lines(out):
    """{name: (psnr, ssim)} and {'psnr'|'ssim': avg} from a CLI's stdout."""
    per, avg = {}, {}
    for ln in out.splitlines():
        m = LINE.match(ln)
        if m:
            per[m[1]] = (float(m[2]), float(m[3]))
        elif ln.startswith("avg "):
            k, v = ln[4:].split(": ")
            avg[k] = float(v)
    return per, avg


def test_cli_matches_jax_cli(tmp_path, capsys):
    from inference import main as jax_main
    from wavemamba_tpu.models.wavemamba import WaveMambaConfig, init_wavemamba
    from wavemamba_tpu.train.checkpoint import export_to_pth

    cfg = WaveMambaConfig(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
    pth = str(tmp_path / "net_g.pth")
    export_to_pth(init_wavemamba(jax.random.PRNGKey(0), cfg), pth)

    lq, gt = tmp_path / "lq", tmp_path / "gt"
    os.makedirs(lq)
    os.makedirs(gt)
    rs = np.random.RandomState(0)
    for name, (h, w) in [("a.png", (40, 56)), ("b.png", (72, 50))]:  # one 128x128 bucket
        cv2.imwrite(str(lq / name), rs.randint(0, 60, (h, w, 3), np.uint8))
        cv2.imwrite(str(gt / name), rs.randint(0, 255, (h, w, 3), np.uint8))

    jax_main(["-i", str(lq), "-g", str(gt), "-w", pth, "-o", str(tmp_path / "jax")] + SIZE_FLAGS)
    jax_out = capsys.readouterr().out
    tinf.main(["-i", str(lq), "-g", str(gt), "-w", pth, "-o", str(tmp_path / "torch"),
               "--device", "cpu"] + SIZE_FLAGS)
    port_out = capsys.readouterr().out

    jper, javg = _lines(jax_out)
    tper, tavg = _lines(port_out)
    assert set(jper) == set(tper) == {"a.png", "b.png"}, (jax_out, port_out)
    assert set(javg) == set(tavg) == {"psnr", "ssim"}
    for name in jper:
        assert abs(jper[name][0] - tper[name][0]) <= 1e-3
        assert abs(jper[name][1] - tper[name][1]) <= 1e-4
        a = cv2.imread(str(tmp_path / "jax" / name)).astype(int)
        b = cv2.imread(str(tmp_path / "torch" / name)).astype(int)
        assert a.shape == b.shape == cv2.imread(str(lq / name)).shape
        assert np.abs(a - b).max() <= 1
    assert abs(javg["psnr"] - tavg["psnr"]) <= 1e-3 and abs(javg["ssim"] - tavg["ssim"]) <= 1e-4
    jb = re.search(r"\(buckets: (\d+)\)", jax_out)
    tb = re.search(r"^buckets: (\d+)$", port_out, re.M)
    assert jb and tb and jb[1] == tb[1] == "1", (jax_out, port_out)


def test_cli_fast_runs_the_bf16_preset(tmp_path, capsys, monkeypatch):
    """`--fast` builds `WaveMambaConfig.fast()` (bf16, the fused scan on bf16
    streams: K1's plain version here) and takes the same path: on the shipped
    XXL4 weights its PNGs are within 3 uint8 levels of the float32 CLI's and
    its PSNR within 0.1 dB (measured: 2 levels, 0.04 dB)."""
    from wavemamba_torch import models as tmodels

    lq, gt = tmp_path / "lq", tmp_path / "gt"
    os.makedirs(lq)
    os.makedirs(gt)
    rs = np.random.RandomState(3)
    for name, (h, w) in [("a.png", (40, 56)), ("b.png", (72, 50))]:
        cv2.imwrite(str(lq / name), rs.randint(0, 60, (h, w, 3), np.uint8))
        cv2.imwrite(str(gt / name), rs.randint(0, 255, (h, w, 3), np.uint8))
    built = []
    real = tmodels.build_network
    monkeypatch.setattr(tinf, "build_network", lambda opt, *a, **k: built.append(opt) or real(opt, *a, **k))
    outs = {}
    for run, flags in [("fast", ["--fast"]), ("parity", [])]:
        tinf.main(["-i", str(lq), "-g", str(gt), "-w", "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth",
                   "-o", str(tmp_path / run), "--device", "cpu"] + flags)
        outs[run] = _lines(capsys.readouterr().out)
    assert (built[0]["compute_dtype"], built[0]["scan_dtype"], built[0]["scan_impl"]) == \
        ("bfloat16", "bfloat16", "pallas_fused")
    assert built[1]["compute_dtype"] == "float32"
    (fper, favg), (pper, pavg) = outs["fast"], outs["parity"]
    assert set(fper) == set(pper) == {"a.png", "b.png"}
    assert abs(favg["psnr"] - pavg["psnr"]) <= 0.1
    for name in fper:
        a = cv2.imread(str(tmp_path / "fast" / name)).astype(int)
        b = cv2.imread(str(tmp_path / "parity" / name)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 3, np.abs(a - b).max()


@pytest.mark.parametrize("flag", [["-w", "model.wmx"], ["--lpips_weights", "x.pth"],
                                  ["--compile_cache", "cache"]])
def test_cli_refuses_what_is_not_ported(flag, tmp_path):
    with pytest.raises(SystemExit) as e:
        tinf.main(["-i", str(tmp_path), "-w", "w.pth", "-o", str(tmp_path / "o"),
                   "--device", "cpu"] + flag)
    assert "ROADMAP" in str(e.value.code)


def test_cli_raises_without_a_card_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from wavemamba_torch.checkpoint import load_network

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_network("ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.main(["-i", str(tmp_path), "-w", "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth",
                   "-o", str(tmp_path / "o")])


def test_bucket_ladder_and_pad_match():
    jl, tl = jbuckets.BucketLadder(max_waste=1.35), tbuckets.BucketLadder(max_waste=1.35)
    rs = np.random.RandomState(1)
    for h, w in [(40, 48), (100, 90), (200, 150), (130, 129), (1080, 1920), (720, 1280),
                 (3, 5)] + [tuple(rs.randint(1, 600, 2)) for _ in range(20)]:
        assert jl.shape_for(h, w) == tl.shape_for(h, w)
    assert jl.buckets == tl.buckets
    x = rs.rand(1, 5, 7, 3).astype(np.float32)
    for H, W in [(5, 7), (8, 16), (128, 128)]:  # the last pad re-reflects
        np.testing.assert_array_equal(tbuckets.pad_to_shape(x, H, W),
                                      jbuckets.pad_to_shape(x, H, W))


@pytest.mark.parametrize("y_channel", [True, False])
@pytest.mark.parametrize("dtype", ["uint8", "float"])
def test_metrics_match(y_channel, dtype):
    rs = np.random.RandomState(2)
    a, b = rs.randint(0, 256, (2, 33, 41, 3)).astype(np.uint8)
    if dtype == "float":
        a, b = a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0
    for kind in ("psnr", "ssim"):
        opt = {"type": kind, "crop_border": 1, "test_y_channel": y_channel}
        assert t_build_metric(opt)(a, b) == j_build_metric(opt)(a, b)


def test_image_helpers_match(tmp_path):
    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tcolor.to_y_channel(img), jcolor.to_y_channel(img))
    for flag in (True, False):
        np.testing.assert_array_equal(tcolor.bgr2ycbcr(img, y_only=flag),
                                      jcolor.bgr2ycbcr(img, y_only=flag))
    batch = timg.img2batch(img)
    np.testing.assert_array_equal(batch, jimg.img2batch(img))
    out = batch * 1.7 - 0.3  # values outside [0, 1] are clamped
    np.testing.assert_array_equal(timg.batch2img(out), jimg.batch2img(out))
    timg.imwrite(img, str(tmp_path / "sub" / "x.png"))
    np.testing.assert_array_equal(timg.imread(str(tmp_path / "sub" / "x.png")), img)
    np.testing.assert_array_equal(timg.imread(str(tmp_path / "sub" / "x.png"), float32=True),
                                  jimg.imread(str(tmp_path / "sub" / "x.png"), float32=True))
    for kw in ({}, {"recursive": True}, {"recursive": True, "full_path": True, "suffix": ".png"}):
        assert sorted(t_scandir(str(tmp_path), **kw)) == sorted(j_scandir(str(tmp_path), **kw))
