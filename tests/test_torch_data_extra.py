"""The rest of the port's data layer against the JAX package on the CPU:
`utils/img_process_util.py` (filter2d, usm_sharp), `data/data_util.py`'s
lmdb pairing and video helpers (duf_downsample), `ops/diffjpeg.py`,
`ops/arch_util.py`, `utils/flow_util.py`, and the gates of the lmdb /
memcached backends (`utils/file_client.py`, `utils/lmdb_util.py`).

Tolerances: filter2d, duf_downsample, flow_warp and the arch_util modules by
max abs difference 1e-6 (sums of a few hundred float32 products in another
order); diff_jpeg's output 1e-5 (two 64-term DCT sums and the colour
transforms in float32), its gradient against `jax.grad` 1e-4 of the
gradient's max abs value; host code (paths, indices, file IO) equal.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch.data import data_util as tdu
from wavemamba_torch.ops import arch_util as tarch
from wavemamba_torch.ops import diffjpeg as tjpeg
from wavemamba_torch.utils import file_client as tfc
from wavemamba_torch.utils import flow_util as tflow
from wavemamba_torch.utils import img_process_util as tipu
from wavemamba_torch.utils import lmdb_util as tlmdb
from wavemamba_tpu.data import data_util as jdu
from wavemamba_tpu.ops import arch_util as jarch
from wavemamba_tpu.ops import diffjpeg as jjpeg
from wavemamba_tpu.utils import file_client as jfc
from wavemamba_tpu.utils import flow_util as jflow
from wavemamba_tpu.utils import img_process_util as jipu
from wavemamba_tpu.utils import lmdb_util as jlmdb

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

ATOL = 1e-6
JPEG_ATOL, JPEG_GRAD_RTOL = 1e-5, 1e-4


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("k", [3, 4, 21])
def test_filter2d_matches_jax(k):
    """Shared (k, k) and per-sample (B, k, k) kernels, NHWC; an even k gives
    one row and column more, as JAX's padding does."""
    img = _rand(3, 24, 20, 3)
    kern = _rand(k, k, seed=1) / k ** 2
    per = _rand(3, k, k, seed=2) / k ** 2
    _close(tipu.filter2d(torch.from_numpy(img), torch.from_numpy(kern)),
           jipu.filter2d(jnp.asarray(img), jnp.asarray(kern)))
    _close(tipu.filter2d(torch.from_numpy(img), torch.from_numpy(per)),
           jipu.filter2d(jnp.asarray(img), jnp.asarray(per)))


def test_usm_sharp_is_bit_equal():
    img = _rand(32, 40, 3, seed=3)
    for kw in ({}, {"weight": 0.3, "radius": 8, "threshold": 4}):
        np.testing.assert_array_equal(tipu.usm_sharp(img, **kw), jipu.usm_sharp(img, **kw))


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_duf_downsample_matches_jax(scale):
    x = _rand(2, 3, 36, 28, 3, seed=scale)
    _close(tdu.duf_downsample(torch.from_numpy(x), 13, scale), jdu.duf_downsample(x, 13, scale))
    _close(tdu.duf_downsample(x[0], 7, scale), jdu.duf_downsample(x[0], 7, scale))
    with pytest.raises(ValueError, match="Only support scale"):
        tdu.duf_downsample(x, 13, 5)


def test_gaussian_kernel_and_frame_indices_are_equal():
    for size, sigma in ((13, 1.6), (7, 0.8), (21, 3.0)):
        np.testing.assert_array_equal(tdu.generate_gaussian_kernel(size, sigma),
                                      jdu.generate_gaussian_kernel(size, sigma))
    for padding in ("replicate", "reflection", "reflection_circle", "circle"):
        for num in (1, 3, 5, 7):
            for crt in range(12):
                assert tdu.generate_frame_indices(crt, 12, num, padding) == \
                    jdu.generate_frame_indices(crt, 12, num, padding), (padding, num, crt)
    with pytest.raises(ValueError, match="odd"):
        tdu.generate_frame_indices(0, 10, 4)
    with pytest.raises(ValueError, match="Wrong padding"):
        tdu.generate_frame_indices(0, 10, 3, "zeros")


def test_read_img_seq_is_equal(tmp_path):
    rs = np.random.RandomState(1)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"), rs.randint(0, 256, (16, 13, 3)).astype(np.uint8))
    for kw in ({}, {"require_mod_crop": True, "scale": 4}):
        got, want = tdu.read_img_seq(str(tmp_path), **kw), jdu.read_img_seq(str(tmp_path), **kw)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    paths = [str(tmp_path / "002.png"), str(tmp_path / "000.png")]
    np.testing.assert_array_equal(tdu.read_img_seq(paths), jdu.read_img_seq(paths))


def _lmdb_folder(root, name, keys):
    folder = root / name
    folder.mkdir()
    (folder / "meta_info.txt").write_text("".join(f"{k}.png (16,16,3) 1\n" for k in keys))
    return str(folder)


def test_lmdb_paths_pair_from_meta_info(tmp_path):
    """Pairing by the keys of two fabricated `meta_info.txt`: JAX's pairs and
    JAX's refusals (different keys, a folder not named .lmdb)."""
    lq = _lmdb_folder(tmp_path, "lq.lmdb", ["0003", "0001", "0002"])
    gt = _lmdb_folder(tmp_path, "gt.lmdb", ["0001", "0002", "0003"])
    assert tdu.paired_paths_from_lmdb([lq, gt], ["lq", "gt"]) == jdu.paired_paths_from_lmdb([lq, gt], ["lq", "gt"])
    assert tdu.paths_from_lmdb(lq) == jdu.paths_from_lmdb(lq) == ["0003", "0001", "0002"]
    other = _lmdb_folder(tmp_path, "other.lmdb", ["0001", "0009"])
    plain = str(tmp_path)
    for args in (([lq, other], ["lq", "gt"]), ([lq, plain], ["lq", "gt"])):
        for fn in (tdu.paired_paths_from_lmdb, jdu.paired_paths_from_lmdb):
            with pytest.raises(ValueError):
                fn(*args)
    for fn in (tdu.paths_from_lmdb, jdu.paths_from_lmdb):
        with pytest.raises(ValueError, match="lmdb format"):
            fn(plain)


def test_lmdb_and_memcached_gates_raise_as_jax(tmp_path):
    """Neither `lmdb` nor a memcached client is installed: each backend and
    `make_lmdb_from_imgs` raise `ImportError`, as JAX's do."""
    for fc in (tfc, jfc):
        with pytest.raises(ImportError, match="lmdb"):
            fc.FileClient("lmdb", db_paths=["x.lmdb"], client_keys=["gt"])
        with pytest.raises(ImportError, match="memcached"):
            fc.FileClient("memcached")
        with pytest.raises(ValueError, match="not supported"):
            fc.FileClient("ftp")
    for lu in (tlmdb, jlmdb):
        with pytest.raises(ImportError, match="lmdb"):
            lu.make_lmdb_from_imgs(str(tmp_path), str(tmp_path / "x.lmdb"))
    path = tmp_path / "blob.bin"
    path.write_bytes(os.urandom(3000))
    assert tlmdb.file_md5(str(path), chunk=1024) == jlmdb.file_md5(str(path))
    disk = tfc.FileClient("disk")
    assert disk.get(str(path), "gt") == jfc.FileClient("disk").get(str(path)) == path.read_bytes()


def _jpeg_input(seed):
    return (_rand(2, 32, 48, 3, seed=seed) * 0.8 + 0.1).astype(np.float32)


@pytest.mark.parametrize("quality", [30, 50, 80])
def test_diff_jpeg_matches_jax(quality):
    """Output within 1e-5 of JAX's; the gradient of sum(out * w) within 1e-4
    of the gradient's max abs value of `jax.grad`'s."""
    x = _jpeg_input(quality)
    w = np.random.RandomState(quality + 1).randn(*x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = tjpeg.diff_jpeg(xt, quality)
    _close(out, jjpeg.diff_jpeg(jnp.asarray(x), quality), JPEG_ATOL)
    (out * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax.grad(lambda v: (jjpeg.diff_jpeg(v, quality) * w).sum())(jnp.asarray(x)))
    assert np.abs(xt.grad.numpy() - want).max() <= JPEG_GRAD_RTOL * np.abs(want).max()
    coefs = tjpeg.jpeg_coefficients(torch.from_numpy(x), quality)
    assert [tuple(c.shape) for c in coefs] == [(2, 24, 8, 8), (2, 6, 8, 8), (2, 6, 8, 8)]


def test_diff_jpeg_refuses_other_sizes():
    with pytest.raises(ValueError, match="multiples of 16"):
        tjpeg.diff_jpeg(torch.zeros(1, 24, 32, 3), 50)


def _flow(seed, h, w):
    """Offsets up to 3 pixels, some reaching outside, some on half pixels."""
    rs = np.random.RandomState(seed)
    flow = (rs.rand(2, h, w, 2) * 6 - 3).astype(np.float32)
    flow[:, ::3, ::4] = np.round(flow[:, ::3, ::4]) + 0.5
    return flow


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp_matches_jax(mode):
    x = _rand(2, 12, 14, 3, seed=4)
    flow = _flow(5, 12, 14)
    got = tarch.flow_warp(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(flow), mode)
    _close(got.permute(0, 2, 3, 1), jarch.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode))
    with pytest.raises(ValueError, match="interp_mode"):
        tarch.flow_warp(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(flow), "bicubic")


def _conv_from_jax(conv, p):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(p["w"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(np.array(p["b"])))


def test_residual_blocks_carry_jax_weights():
    """ResidualBlockNoBN and make_layer with weights from JAX's params (HWIO ->
    OIHW), NCHW against JAX's NHWC apply."""
    x = _rand(2, 10, 12, 8, seed=6)
    init, apply = jarch.make_layer(jarch.init_residual_block_no_bn, jarch.residual_block_no_bn_apply, 2)
    params = init(jax.random.PRNGKey(0), 8)
    layer = tarch.make_layer(tarch.ResidualBlockNoBN, 2, num_feat=8, res_scale=0.5)
    for block, (p, _) in zip(layer, params):
        _conv_from_jax(block.conv1, p["conv1"])
        _conv_from_jax(block.conv2, p["conv2"])
    want = apply([p for p, _ in params], jnp.asarray(x), 0.5)
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upsample_carries_jax_weights(scale):
    x = _rand(1, 6, 7, 4, seed=scale)
    params = jarch.init_upsample(jax.random.PRNGKey(scale), scale, 4)
    up = tarch.Upsample(scale, 4)
    convs = [m for m in up if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == len(params)
    for conv, (_, p) in zip(convs, params):
        _conv_from_jax(conv, p)
    got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jarch.upsample_apply(params, jnp.asarray(x)))
    with pytest.raises(ValueError, match="not supported"):
        tarch.Upsample(5, 4)


def test_initializers_follow_their_laws():
    """trunc_normal_ stays in [a, b] around its mean with JAX's spread;
    default_init_weights gives kaiming-normal * scale and filled biases;
    both repeat from the same generator."""
    t = torch.empty(20000)
    tarch.trunc_normal_(t, mean=0.5, std=1.0, a=-1.0, b=2.0, generator=torch.Generator().manual_seed(1))
    j = np.asarray(jarch.trunc_normal(jax.random.PRNGKey(1), (20000,), 0.5, 1.0, -1.0, 2.0))
    assert t.min() >= -1.0 and t.max() <= 2.0
    assert abs(float(t.mean()) - j.mean()) < 0.03 and abs(float(t.std()) - j.std()) < 0.03
    again = tarch.trunc_normal_(torch.empty(20000), 0.5, 1.0, -1.0, 2.0, torch.Generator().manual_seed(1))
    assert torch.equal(t, again)
    conv = torch.nn.Conv2d(32, 64, 3)
    tarch.default_init_weights(conv, scale=0.1, bias_fill=0.25, generator=torch.Generator().manual_seed(2))
    assert abs(float(conv.weight.detach().std()) - 0.1 * (2.0 / (32 * 9)) ** 0.5) < 0.002
    assert bool((conv.bias == 0.25).all())


def test_flow_io_matches_jax(tmp_path):
    """.flo files and quantized flow images: written and read back as JAX's."""
    flow = _flow(7, 9, 11)[0] * 0.1
    for fu, tag in ((tflow, "t"), (jflow, "j")):
        fu.flowwrite(flow, str(tmp_path / f"{tag}.flo"))
        fu.flowwrite(flow, str(tmp_path / f"{tag}.png"), quantize=True)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(tflow.flowread(str(tmp_path / "t.flo")), flow)
    np.testing.assert_array_equal(tflow.flowread(str(tmp_path / "t.png"), quantize=True),
                                  jflow.flowread(str(tmp_path / "j.png"), quantize=True))
    for got, want in zip(tflow.quantize_flow(flow), jflow.quantize_flow(flow)):
        np.testing.assert_array_equal(got, want)
