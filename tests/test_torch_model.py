"""The port's model (`wavemamba_torch/models/wavemamba.py`) and weight
handling (`wavemamba_torch/convert.py`) against wavemamba_tpu on the CPU.

JAX parameters cross over through `state_dict_from_jax`; inputs are made
with numpy. Both sides run exact float32 on the CPU (the JAX side with its
default `scan_impl='chunked'`), so the differences are summation order
only: 1e-5 absolute for the blocks and the shipped checkpoint.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch import convert
from wavemamba_torch.models import build_network, param_count
from wavemamba_torch.models import wavemamba as twm
from wavemamba_tpu.convert.torch_export import params_to_state_dict
from wavemamba_tpu.convert.torch_import import load_wavemamba_checkpoint
from wavemamba_tpu.models import wavemamba as jwm

XXL4 = "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth"
ATOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _module(cls, params, *args):
    m = cls(*args).eval()
    m.load_state_dict(convert.state_dict_from_jax(_np_tree(params)), strict=True)
    return m


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _image(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


def test_ss2d_matches():
    cfg = jwm.WaveMambaConfig(wf=16)
    p = jwm.init_ss2d(jax.random.PRNGKey(0), cfg)
    x = _image(1, 2, 12, 20, 16)
    want = np.asarray(jax.jit(functools.partial(jwm.ss2d_apply, cfg=cfg))(p, x=x))
    m = _module(twm.SS2D, p, twm.WaveMambaConfig(wf=16))
    with torch.no_grad():
        got = _nhwc(m(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_lfss_block_matches():
    cfg = jwm.WaveMambaConfig(wf=16)
    p = jwm.init_lfss_block(jax.random.PRNGKey(2), cfg)
    x = _image(3, 1, 16, 24, 16) - 0.5
    want = np.asarray(jax.jit(functools.partial(jwm.lfss_block_apply, cfg=cfg))(p, x=x))
    m = _module(twm.LFSSBlock, p, twm.WaveMambaConfig(wf=16))
    with torch.no_grad():
        got = _nhwc(m(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("restormer", [False, True])
def test_hfe_block_matches(restormer):
    p = jwm.init_hfe_block(jax.random.PRNGKey(4), 16, ffn_restormer=restormer)
    x = _image(5, 2, 8, 12, 16) - 0.5
    perc = _image(6, 2, 8, 12, 16) - 0.5
    fn = jax.jit(functools.partial(jwm.hfe_block_apply, ffn_restormer=restormer))
    want = np.asarray(fn(p, x, perc))
    m = _module(twm.HFEBlock, p, 16, restormer)
    with torch.no_grad():
        got = _nhwc(m(_nchw(x), _nchw(perc)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_small_unet_matches():
    kw = dict(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
    cfg = jwm.WaveMambaConfig(**kw)
    params = jwm.init_wavemamba(jax.random.PRNGKey(7), cfg)
    x = _image(8, 1, 32, 40, 3, scale=0.3)
    want = np.asarray(jax.jit(lambda p, t: jwm.wavemamba_apply(p, cfg, t))(params, x))
    sd = convert.state_dict_from_jax(_np_tree(params))
    model = build_network({"type": "WaveMamba", **kw}, sd, device="cpu")
    got = twm.wavemamba_apply(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_shipped_xxl4_matches_jax():
    """The flagship checkpoint, loaded by each package its own way, on a
    non-square 64x96 low-light input."""
    from wavemamba_torch.checkpoint import load_network

    cfg = jwm.WaveMambaConfig()
    params = load_wavemamba_checkpoint(XXL4)
    x = _image(0, 1, 64, 96, 3, scale=0.12)
    want = np.asarray(jax.jit(lambda p, t: jwm.wavemamba_apply(p, cfg, t))(params, x))
    model = build_network({"type": "WaveMamba"}, load_network(XXL4, device="cpu"), device="cpu")
    assert param_count(model) == 1_512_718
    got = twm.wavemamba_apply(model, torch.from_numpy(x)).numpy()
    assert got.shape == (1, 64, 96, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.mean() > x.mean()  # a low-light model brightens


def test_state_dict_from_jax_round_trips_the_pth():
    ref = convert.load_pth(XXL4)
    got = convert.state_dict_from_jax(_np_tree(load_wavemamba_checkpoint(XXL4)))
    assert list(got) == list(ref) and len(ref) == 591
    for k, v in ref.items():
        assert got[k].shape == v.shape and torch.equal(got[k], v.float()), k
    model = twm.WaveMamba().eval()
    model.load_state_dict(got, strict=True)
    assert param_count(model) == 1_512_718


def test_state_dict_from_jax_matches_jax_exporter():
    """On a random tree with the Restormer FFN (keys the shipped model lacks)."""
    cfg = jwm.WaveMambaConfig(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1),
                              ffn_restormer=True)
    tree = _np_tree(jwm.init_wavemamba(jax.random.PRNGKey(9), cfg))
    want = params_to_state_dict(tree)
    got = convert.state_dict_from_jax(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = twm.WaveMamba(twm.WaveMambaConfig(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1),
                                              ffn_restormer=True))
    model.load_state_dict(got, strict=True)
    assert param_count(model) == jwm.param_count(tree)


def test_pad_to_multiple_matches():
    x = _image(10, 1, 13, 6, 3)
    want, h, w = jwm.pad_to_multiple(jnp.asarray(x), 8)
    got, gh, gw = twm.pad_to_multiple(x, 8)
    assert (gh, gw) == (h, w) == (13, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
