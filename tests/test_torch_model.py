"""The port's model (`wavemamba_torch/models/wavemamba.py`) and weight
handling (`wavemamba_torch/convert.py`) against wavemamba_tpu on the CPU.

JAX parameters cross over through `state_dict_from_jax`; inputs are made
with numpy. Both sides run exact float32 on the CPU (the JAX side with its
default `scan_impl='chunked'`), so the differences are summation order
only: 1e-5 absolute for the blocks and the shipped checkpoint.
"""

import functools
import warnings

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

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


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


# The unfused route: every `scan_impl` against the JAX model of the same
# setting (its 'pallas' runs the Pallas kernels in interpret mode off the TPU).
# Forward 1e-5 absolute as above; a gradient by its max difference over the
# gradient's max, 1e-4: exact float32 on both sides, other summation orders.
UNFUSED = ["ref", "chunked", "par", "pallas"]
GRAD_REL = 1e-4


def _grad_rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("impl", UNFUSED)
def test_ss2d_unfused_matches_forward_and_gradients(impl):
    kw = dict(wf=16, scan_impl=impl, scan_chunk=64, scan_sub=8)
    cfg = jwm.WaveMambaConfig(**kw)
    p = jwm.init_ss2d(jax.random.PRNGKey(0), cfg)
    x = _image(1, 2, 12, 20, 16)  # non-square: the column directions differ from the rows
    dy = _image(2, 2, 12, 20, 16) - 0.5
    def fwd_and_grads(p, x):  # one jit: the compile is this test's cost
        y, vjp = jax.vjp(lambda p, x: jwm.ss2d_apply(p, cfg, x), p, x)
        return y, vjp(jnp.asarray(dy))

    want, jgrads = jax.jit(fwd_and_grads)(p, x)
    want = np.asarray(want)
    m = _module(twm.SS2D, p, twm.WaveMambaConfig(**kw)).train()
    xt = _nchw(x).requires_grad_()
    y = m(xt)
    np.testing.assert_allclose(_nhwc(y), want, atol=ATOL, rtol=0)
    (y * _nchw(dy)).sum().backward()
    assert _grad_rel(_nhwc(xt.grad), np.asarray(jgrads[1])) < GRAD_REL
    wgrads = convert.state_dict_from_jax(_np_tree(jgrads[0]))
    for name, prm in m.named_parameters():
        assert _grad_rel(prm.grad.numpy(), wgrads[name].numpy()) < GRAD_REL, (impl, name)


@pytest.mark.parametrize("impl", UNFUSED)
def test_small_unet_matches_with_scan_impl(impl):
    kw = dict(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1), scan_impl=impl, scan_chunk=64,
              scan_sub=8, remat=False)
    cfg = jwm.WaveMambaConfig(**kw)
    params = jwm.init_wavemamba(jax.random.PRNGKey(7), cfg)
    x = _image(8, 1, 32, 40, 3, scale=0.3)
    gt = _image(9, 1, 32, 40, 3)
    def loss(p):  # the output rides along as aux: one jit, one compile
        out = jwm.wavemamba_apply(p, cfg, x)
        return jnp.mean(jnp.abs(out - gt)), out

    (jloss, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = np.asarray(want)
    sd = convert.state_dict_from_jax(_np_tree(params))
    model = build_network({"type": "WaveMamba", **kw}, sd, device="cpu")
    assert all(m.scan_impl == impl for m in model.modules() if isinstance(m, twm.SS2D))
    np.testing.assert_allclose(twm.wavemamba_apply(model, torch.from_numpy(x)).numpy(), want,
                               atol=ATOL, rtol=0)
    total = (twm.wavemamba_forward(model, torch.from_numpy(x)) - torch.from_numpy(gt)).abs().mean()
    total.backward()
    assert abs(float(total.detach()) - float(jloss)) < 1e-6
    wgrads = convert.state_dict_from_jax(_np_tree(jgrads))
    for name, prm in model.named_parameters():
        assert _grad_rel(prm.grad.numpy(), wgrads[name].numpy()) < GRAD_REL, (impl, name)


def test_unfused_scan_can_be_rerouted():
    """`set_unfused_scan` sends the unfused route's scan elsewhere (the plain
    version on the card, in `chip_smoke.py`) and None restores the dispatcher."""
    from wavemamba_torch.ops.scan import selective_scan_plain

    cfg = twm.WaveMambaConfig(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1), scan_impl="pallas")
    model = twm.init_wavemamba(twm.WaveMamba(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_image(11, 1, 16, 24, 3))
    want = twm.wavemamba_apply(model, x)
    calls = []
    twm.set_unfused_scan(model, lambda *a: calls.append(1) or selective_scan_plain(*a))
    np.testing.assert_array_equal(twm.wavemamba_apply(model, x).numpy(), want.numpy())
    assert len(calls) == 6  # one scan per SS2D: three levels, down and up
    twm.set_unfused_scan(model, None)
    twm.wavemamba_apply(model, x)
    assert len(calls) == 6


def test_network_g_keys_are_honoured_or_refused():
    """The factory's one rule: config fields are honoured (the bf16 dtypes
    among them), the JAX package's other execution knobs pass at the values
    the port runs and raise naming their ROADMAP item otherwise, anything else
    is a KeyError."""
    from wavemamba_torch.models import config_from_opt

    base = {"type": "WaveMamba", "wf": 16, "n_l_blocks": [1, 1, 1], "n_h_blocks": [1, 1, 1]}
    cfg = config_from_opt({**base, "scan_impl": "pallas", "scan_chunk": 128, "scan_sub": 8,
                           "compute_dtype": "float32", "scan_dtype": "float32", "conv_impl": "xla"})
    assert (cfg.scan_impl, cfg.scan_chunk, cfg.scan_sub) == ("pallas", 128, 8)
    assert cfg.n_l_blocks == (1, 1, 1)
    assert config_from_opt(base).scan_impl == "pallas_fused"  # the port's default
    assert config_from_opt({**base, "conv_impl": "fused"}).conv_impl == "fused"  # inference only
    bf16 = config_from_opt({**base, "compute_dtype": "bfloat16", "scan_dtype": "bfloat16"})
    assert (bf16.compute_dtype, bf16.scan_dtype) == ("bfloat16", "bfloat16")
    for key, value, match in [("conv1x1_as_conv", ["ffn"], "item 15"),
                              ("scan_impl", "seq_sharded", "item 9")]:
        with pytest.raises(NotImplementedError, match=match):
            config_from_opt({**base, key: value})
    # remat_policy is a field: both of the JAX package's policies, its default too
    assert config_from_opt(base).remat_policy == jwm.WaveMambaConfig().remat_policy == "save_scan"
    for policy in ("save_scan", "full"):
        assert config_from_opt({**base, "remat_policy": policy}).remat_policy == policy
    from wavemamba_torch.models import init_network

    fused_bf16 = config_from_opt({**base, "conv_impl": "fused", "compute_dtype": "bfloat16"})
    assert (fused_bf16.conv_impl, fused_bf16.compute_dtype) == ("fused", "bfloat16")  # raised before
    model = init_network({**base, "conv_impl": "fused", "compute_dtype": "bfloat16"},
                         torch.Generator().manual_seed(0), device="cpu", train=False)
    with torch.no_grad():
        y = model.restoration_network(torch.rand(1, 3, 16, 24).bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (1, 3, 16, 24)
    with pytest.raises(ValueError, match="unknown scan_dtype"):
        config_from_opt({**base, "scan_dtype": "float16"})
    with pytest.raises(KeyError, match="unknown network_g key"):
        config_from_opt({**base, "widht": 3})
    with pytest.raises(ValueError, match="unknown scan_impl"):
        config_from_opt({**base, "scan_impl": "fast"})
    with pytest.raises(NotImplementedError, match="item 11"):
        config_from_opt({"type": "ART"})


@pytest.mark.parametrize("extra", [{"remat": True}, {}, {"remat": True, "remat_policy": "full"},
                                   {"remat": False}])
def test_config_from_opt_names_the_remat_policy_it_runs(extra):
    """The port runs the JAX package's recompute policies, so `config_from_opt`
    warns about none of them, and the config holds the policy and the remat
    switch that the JAX config of the same dict holds ('save_scan' where
    the dict names none)."""
    from wavemamba_torch.models import config_from_opt

    base = {"type": "WaveMamba", "wf": 16, "n_l_blocks": [1, 1, 1], "n_h_blocks": [1, 1, 1]}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = config_from_opt({**base, **extra})
    assert [str(w.message) for w in caught if "remat" in str(w.message)] == []
    want = jwm.WaveMambaConfig(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1), **extra)
    assert (cfg.remat, cfg.remat_policy) == (want.remat, want.remat_policy)


def test_load_network_points_elsewhere_for_jax_artifacts(tmp_path):
    """An Orbax directory names the JAX package's converter to a state dict;
    a `.wmx` artifact names the deployment item."""
    from wavemamba_torch.checkpoint import load_network

    with pytest.raises(ValueError, match="params_to_state_dict"):
        load_network(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="item 10"):
        load_network(str(tmp_path / "model.wmx"), device="cpu")
