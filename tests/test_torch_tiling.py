"""Tiled inference: the port's `models/tiling.py:tiled_apply`, the runner's
`test(tile=...)` and the CLI's `--tile` against the JAX package on the CPU.

`tiled_apply` is numpy on both sides: with the same tile function the two give
the same bits. Through a model the tiles' forwards differ by float32 sums
only: 1e-5 absolute, as the whole-image runner test; the CLI's PNGs within one
uint8 level and its PSNR within 1e-3 dB, as the whole-image CLI test.
"""

import logging
import os
import re

import cv2
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavemamba_torch import convert
from wavemamba_torch import inference as tinf
from wavemamba_torch.models import tiling as ttiling
from wavemamba_torch.runner import build_model
from wavemamba_tpu import runner as jrunner
from wavemamba_tpu.models import tiling as jtiling

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


def _blur(x):
    """A 3x3 box blur per channel on (B, h, w, C) numpy, zero padded."""
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    k = torch.full((t.shape[1], 1, 3, 3), 1.0 / 9.0)
    return F.conv2d(t, k, padding=1, groups=t.shape[1]).numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kw", [dict(tile_size=48, tile_pad=8, pad_multiple=8),
                                dict(tile_size=32, tile_pad=4, pad_multiple=4, tile_batch=3)])
def test_tiled_apply_matches_jax(kw):
    """Identity and a local op, the cases of `tests/test_misc_ops.py`: the same
    bits as the JAX package's `tiled_apply`; identity gives the image back, and
    the blur is seam-free away from the frame's border."""
    img = np.random.RandomState(5).rand(1, 100, 130, 3).astype(np.float32)
    ident = ttiling.tiled_apply(lambda x: x, img, **kw)
    np.testing.assert_array_equal(ident, jtiling.tiled_apply(lambda x: x, img, **kw))
    np.testing.assert_array_equal(ident, img)
    calls = []
    got = ttiling.tiled_apply(lambda x: calls.append(x.shape) or _blur(x), img, **kw)
    np.testing.assert_array_equal(got, jtiling.tiled_apply(_blur, img, **kw))
    assert len(set(calls)) == 1  # one tile shape, one batch size
    np.testing.assert_allclose(got[:, 2:-2, 2:-2], _blur(img)[:, 2:-2, 2:-2], atol=1e-6)


def test_tiled_apply_mesh_waits_for_multi_gpu():
    """One rank (no mesh): `tiled_apply_mesh` is `tiled_apply` of the same
    forward, bit for bit, its tile batch the JAX package's default (8); the
    ranks' cases are `tests/test_torch_parallel.py`'s."""
    from wavemamba_torch.models import init_network, wavemamba_apply

    model = init_network(dict(NET), torch.Generator().manual_seed(0), device="cpu", train=False)
    img = np.random.RandomState(2).rand(1, 40, 56, 3).astype(np.float32)
    calls = []

    def apply(m, x):
        calls.append(tuple(x.shape))
        return wavemamba_apply(m, x)

    got = ttiling.tiled_apply_mesh(apply, model, img, None, tile_size=24, tile_pad=4)
    want = ttiling.tiled_apply(lambda t: wavemamba_apply(model, torch.from_numpy(t)).numpy(),
                               img, tile_size=24, tile_pad=4)
    np.testing.assert_array_equal(got, want)
    assert calls == [(8, 32, 32, 3)]  # 2 x 3 tiles, one batch padded to 8
    with pytest.raises(ValueError, match="one image"):
        ttiling.tiled_apply(lambda x: x, np.zeros((2, 8, 8, 3)))


NET = {"type": "WaveMamba", "in_chn": 3, "wf": 8, "n_l_blocks": [1, 1, 1],
       "n_h_blocks": [1, 1, 1], "ffn_scale": 2.0, "scan_impl": "chunked"}


def _opt(tmp_path):
    return {"name": "tiles", "model_type": "FeMaSRModel", "manual_seed": 0, "is_train": False,
            "device": "cpu", "network_g": dict(NET), "path": {}, "val": {}}


def test_runner_tiles_like_the_jax_runner(tmp_path, monkeypatch):
    """`RestorationModel.test(tile=...)` against the JAX runner's, the same
    weights: the tiled outputs within 1e-5, and not the whole-image output
    (the tiles see reflected context at their seams' ends)."""
    jopt = _opt(tmp_path)
    # The JAX runner's `get_root_logger` turns the `wavemamba_tpu` logger's
    # propagation off for the whole process: put it back after this test, so
    # that a later test's caplog still hears that logger.
    monkeypatch.setattr(logging.getLogger("wavemamba_tpu"), "propagate",
                        logging.getLogger("wavemamba_tpu").propagate)
    jmodel = jrunner.build_model(jopt)
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params))
    torch.save({"params": sd}, tmp_path / "w.pth")
    opt = _opt(tmp_path)
    opt["path"]["pretrain_network_g"] = str(tmp_path / "w.pth")
    model = build_model(opt)
    x = np.random.RandomState(1).rand(1, 45, 70, 3).astype(np.float32)
    tile = {"tile_size": 32, "tile_pad": 8}
    got, want = model.test(x, tile=tile), jmodel.test(x, tile=tile)
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - model.test(x)).max() > 1e-4


LINE = re.compile(r"^(\S+): [\d.]+s  psnr ([\d.]+)  ssim ([\d.]+)$")
SIZE_FLAGS = ["--wf", "8", "--n_l_blocks", "1", "1", "1", "--n_h_blocks", "1", "1", "1"]


def test_cli_tile_matches_jax_cli(tmp_path, capsys):
    """`--tile 32` on a folder of two images, against the JAX CLI's `--tile 32`
    with the same weights."""
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
    for name, (h, w) in [("a.png", (40, 56)), ("b.png", (72, 50))]:
        cv2.imwrite(str(lq / name), rs.randint(0, 60, (h, w, 3), np.uint8))
        cv2.imwrite(str(gt / name), rs.randint(0, 255, (h, w, 3), np.uint8))

    jax_main(["-i", str(lq), "-g", str(gt), "-w", pth, "-o", str(tmp_path / "jax"), "--tile", "32"]
             + SIZE_FLAGS)
    jax_out = capsys.readouterr().out
    tinf.main(["-i", str(lq), "-g", str(gt), "-w", pth, "-o", str(tmp_path / "torch"),
               "--tile", "32", "--device", "cpu"] + SIZE_FLAGS)
    port_out = capsys.readouterr().out
    jper = {m[1]: float(m[2]) for m in map(LINE.match, jax_out.splitlines()) if m}
    tper = {m[1]: float(m[2]) for m in map(LINE.match, port_out.splitlines()) if m}
    assert set(jper) == set(tper) == {"a.png", "b.png"}, (jax_out, port_out)
    for name in jper:
        assert abs(jper[name] - tper[name]) <= 1e-3
        a = cv2.imread(str(tmp_path / "jax" / name)).astype(int)
        b = cv2.imread(str(tmp_path / "torch" / name)).astype(int)
        assert a.shape == b.shape == cv2.imread(str(lq / name)).shape
        assert np.abs(a - b).max() <= 1
