"""The port's fused conv chains (`wavemamba_torch/experimental/conv_fused.py`)
against the JAX package's on the CPU, and the `conv_impl: fused` route.

The JAX chains run their Pallas kernels in interpret mode, as
`tests/test_conv_fused.py` does; the port's run their plain version, which is
what a CPU tensor takes. Same weights (the JAX init carried over by
`convert.state_dict_from_jax`), same numpy inputs. Both round the operands of
every 1x1 and dense 3x3 to bf16 (nearest even) and sum in float32, so the
outputs differ by the order of float32 sums, ~1e-6. A chain that rounds the
output of a float32 stage to bf16 (paconv: the product with the sigmoid gate
feeds the second dense 3x3) can see one input land on the other side of a bf16
rounding boundary: then one element moves by a bf16 step times a weight. So:
1e-5 absolute on at least 97% of the elements, and the JAX test's 2e-2 on all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from wavemamba_torch import convert
from wavemamba_torch.experimental import conv_fused as tcf
from wavemamba_torch.models import build_network, config_from_opt, init_network
from wavemamba_torch.models import wavemamba as twm
from wavemamba_torch.ops.nn import LayerNorm
from wavemamba_tpu.experimental import conv_fused as jcf
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.ops.nn import init_conv2d

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

TIGHT, TIGHT_SHARE, LOOSE = 1e-5, 0.97, 2e-2
XXL4 = "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth"
WRAPPERS = ["ffn_chain", "lfss_ffn_block", "qkv_chain", "paconv_chain", "ff_in_chain",
            "ff_out_chain", "restormer_chain", "dw_act", "dense3x3"]


def _load(module, tree):
    module.load_state_dict(convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree)),
                           strict=True)
    return module.eval()


def _ln(c, eps, seed):
    """A non-trivial LayerNorm: (JAX (g, b, eps), the port's module)."""
    rs = np.random.RandomState(seed)
    g = (1.0 + 0.3 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)
    m = LayerNorm(c, eps=eps)
    m.load_state_dict({"weight": torch.from_numpy(g), "bias": torch.from_numpy(b)})
    return (jnp.asarray(g), jnp.asarray(b), eps), m


def _pair(name, c, seed=0):
    """(JAX call, port call) of one wrapper on c channels, NHWC / NCHW in."""
    key = jax.random.PRNGKey(seed)
    jln, tln = _ln(c, 1e-6, seed + 1)
    if name in ("ffn_chain", "lfss_ffn_block"):
        p = jwm.init_ffn(key, c)
        m = _load(twm.FFN(c), p)
        if name == "ffn_chain":
            return (lambda x: jcf.ffn_chain(p, x)), (lambda x: tcf.ffn_chain(m, x))
        jln5, tln5 = _ln(c, 1e-5, seed + 2)
        skip = np.random.RandomState(seed + 3).rand(c).astype(np.float32)
        return (lambda x: jcf.lfss_ffn_block({"g": jln5[0], "b": jln5[1]}, p, jnp.asarray(skip), x),
                lambda x: tcf.lfss_ffn_block(tln5, m, torch.from_numpy(skip), x))
    if name == "qkv_chain":  # with the block's norm1 folded in
        p = jwm.init_cmt_attention(key, c)
        m = _load(twm.CMTAttention(c), p)
        return (lambda x: jcf.qkv_chain(p, x, ln=jln)), (lambda x: tcf.qkv_chain(m, x, ln=tln))
    if name == "paconv_chain":
        p = jwm.init_paconv(key, c)
        m = _load(twm.PAConv(c), p)
        return (lambda x: jcf.paconv_chain(p, x)), (lambda x: tcf.paconv_chain(m, x))
    if name in ("ff_in_chain", "ff_out_chain"):
        p = jwm.init_feed_forward(key, c)
        m = _load(twm.FeedForward(c), p)
        if name == "ff_in_chain":  # with the block's norm2 folded in
            return (lambda x: jcf.ff_in_chain(p["project_in"], x, ln=jln),
                    lambda x: tcf.ff_in_chain(m.project_in, x, ln=tln))
        return (lambda x: jcf.ff_out_chain(p["project_out"], x),
                lambda x: tcf.ff_out_chain(m.project_out, x))
    if name == "restormer_chain":  # LN in front, the block residual inside
        p = jwm.init_feed_forward_restormer(key, c)
        m = _load(twm.FeedForwardRestormer(c), p)
        return (lambda x: jcf.restormer_chain(p, x, ln=jln, residual=True),
                lambda x: tcf.restormer_chain(m, x, ln=tln, residual=True))
    if name == "dw_act":
        p = init_conv2d(key, 3, 3, c, c, groups=c)
        m = _load(nn.Conv2d(c, c, 3, padding=1, groups=c), p)
        return (lambda x: jcf.dw_act(p, x, "silu")), (lambda x: tcf.dw_act(m, x, "silu"))
    p = init_conv2d(key, 3, 3, c, 2 * c)
    m = _load(nn.Conv2d(c, 2 * c, 3, padding=1), p)
    return (lambda x: jcf.dense3x3(p, x)), (lambda x: tcf.dense3x3(m, x))


def _run_both(jfn, tfn, shape, seed):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    with torch.no_grad():
        got = tfn(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    return np.transpose(got.numpy(), (0, 2, 3, 1)), want


def _assert_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    assert float((d <= TIGHT).mean()) >= TIGHT_SHARE, (float(d.max()), float((d > TIGHT).mean()))
    assert float(d.max()) <= LOOSE


@pytest.mark.parametrize("hw", [(16, 128), (17, 130), (40, 48), (8, 8)])
@pytest.mark.parametrize("name", WRAPPERS)
def test_chain_wrapper_matches_jax(name, hw):
    c = 16 if name == "paconv_chain" else 8
    jfn, tfn = _pair(name, c)
    _assert_close(*_run_both(jfn, tfn, (1, *hw, c), seed=3))


def test_paconv_halo2_band_and_tile_match_jax():
    """The halo-2 chain at 21x37, where border masking matters most: the port's
    plain version against the JAX band kernel and the JAX tile kernel."""
    p = jwm.init_paconv(jax.random.PRNGKey(2), 16)
    m = _load(twm.PAConv(16), p)
    got, band = _run_both(lambda x: jcf.paconv_chain(p, x, band_h=8),
                          lambda x: tcf.paconv_chain(m, x), (1, 21, 37, 16), seed=3)
    _, tile = _run_both(lambda x: jcf.paconv_chain(p, x, band_h=None),
                        lambda x: tcf.paconv_chain(m, x), (1, 21, 37, 16), seed=3)
    np.testing.assert_allclose(band, tile, rtol=1e-5, atol=1e-5)
    _assert_close(got, band)
    _assert_close(got, tile)


def test_wrappers_route_to_band_then_tile(monkeypatch):
    """`_run` takes the band entry point (K7) by default, the tile entry
    point (K6) with band_h=None or inside `chain_route('tile')`, and neither
    inside `chain_route('plain')`; all give the plain version's output on a CPU
    tensor."""
    calls = []
    for entry in ("fused_chain", "fused_chain_band"):
        real = getattr(tcf, entry)
        monkeypatch.setattr(tcf, entry, lambda *a, _r=real, _n=entry, **k: calls.append(_n) or _r(*a, **k))
    conv = nn.Conv2d(8, 8, 3, padding=1, groups=8)
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 8, 10, 30).astype(np.float32))
    with torch.no_grad():
        band = tcf.dw_act(conv, x)
        tile = tcf.dw_act(conv, x, band_h=None)
        with tcf.chain_route("tile"):
            routed = tcf.dw_act(conv, x)
        with tcf.chain_route("plain"):
            plain = tcf.dw_act(conv, x)
        after = tcf.dw_act(conv, x)
    assert calls == ["fused_chain_band", "fused_chain", "fused_chain", "fused_chain_band"]
    for y in (tile, routed, plain, after):
        assert torch.equal(y, band)
    with pytest.raises(ValueError, match="unknown chain route"):
        with tcf.chain_route("cudnn"):
            pass


def test_chain_refuses_what_it_does_not_run():
    conv = nn.Conv2d(8, 8, 3, padding=1, groups=8)
    x = torch.rand(1, 8, 6, 6)
    with pytest.raises(RuntimeError, match="inference only"):  # no backward: the weights need one
        tcf.dw_act(conv, x)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="item 4"):
            tcf.dw_act(conv, x.bfloat16())
        with pytest.raises(ValueError, match="unknown stage"):
            tcf.fused_chain(x, (("conv", conv.weight, None),))
        with pytest.raises(ValueError, match="does not fit"):
            tcf.fused_chain(x, (("pw", torch.rand(4, 5), None),))
        with pytest.raises(ValueError, match="res0"):
            tcf.fused_chain(x, (("pw", torch.rand(4, 8), None), ("res0", None)))


def test_gelu_is_the_tanh_form():
    """The chains' GELU is the TPU kernel's tanh form, not the stock route's erf."""
    x = torch.linspace(-4, 4, 97).view(1, 1, 1, 97)
    with torch.no_grad():
        y = tcf.fused_chain_plain(x, (("act", "gelu"),))
    assert torch.equal(y, torch.nn.functional.gelu(x, approximate="tanh"))
    assert float((y - torch.nn.functional.gelu(x)).abs().max()) > 1e-4


TINY = {"type": "WaveMamba", "wf": 8, "n_l_blocks": [1, 1, 1], "n_h_blocks": [1, 1, 1]}


def test_conv_impl_fused_builds_for_inference_only():
    cfg = config_from_opt({**TINY, "conv_impl": "fused"})
    assert cfg.conv_impl == "fused"
    with pytest.raises(ValueError, match="unknown conv_impl"):
        config_from_opt({**TINY, "conv_impl": "pallas"})
    with pytest.raises(NotImplementedError, match="inference only"):
        init_network({**TINY, "conv_impl": "fused"}, torch.Generator().manual_seed(0), device="cpu")
    model = init_network({**TINY, "conv_impl": "fused"}, torch.Generator().manual_seed(0),
                         device="cpu", train=False)
    assert not model.training
    from wavemamba_torch.train.trainer import TrainConfig, create_train_state

    with pytest.raises(NotImplementedError, match="inference only"):
        create_train_state(model, TrainConfig())
    x = torch.rand(1, 16, 24, 3)
    with pytest.raises(RuntimeError, match="inference only"):  # a backward through a chain
        twm.wavemamba_forward(model, x).sum().backward()
    assert twm.wavemamba_apply(model, x).shape == x.shape


def test_fused_route_on_the_shipped_checkpoint(monkeypatch):
    """XXL4 at 64x96 with `conv_impl: fused` against the stock float32 route on
    the same weights: 76 chains a forward, and the output within the bf16
    operands' and tanh GELU's reach of the stock one: max abs 1e-2 and PSNR
    above 55 dB between the two (2.1e-3 and 65 dB when written), on outputs
    up to 0.7."""
    from wavemamba_torch.checkpoint import load_network

    sd = load_network(XXL4, device="cpu")
    fused = build_network({"type": "WaveMamba", "conv_impl": "fused"}, sd, device="cpu")
    stock = build_network({"type": "WaveMamba"}, sd, device="cpu")
    calls = []
    real = tcf.fused_chain_plain
    monkeypatch.setattr(tcf, "fused_chain_plain", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy((np.random.RandomState(0).rand(1, 64, 96, 3) * 0.12).astype(np.float32))
    got = twm.wavemamba_apply(fused, x)
    assert len(calls) == 76
    want = twm.wavemamba_apply(stock, x)
    assert torch.isfinite(got).all() and got.shape == x.shape
    err = (got - want).abs()
    psnr = 10 * np.log10(1.0 / float((err ** 2).mean()))
    assert float(err.max()) <= 1e-2 and psnr >= 55.0, (float(err.max()), psnr)


def test_runner_serves_the_fused_route_and_refuses_to_train_it(tmp_path):
    """What `pipelines.test` runs with `--force_yml network_g:conv_impl=fused`:
    `build_model` evaluates the fused route (the same output as its plain
    chains give the model directly); `pipelines.train` (is_train) refuses it."""
    from wavemamba_torch.runner import build_model

    opt = {"name": "fused", "model_type": "FeMaSRModel", "manual_seed": 0, "is_train": False,
           "device": "cpu", "network_g": {**TINY, "conv_impl": "fused"}, "path": {}, "val": {}}
    model = build_model(opt)
    assert model.cfg.conv_impl == "fused" and not model.model.training
    x = np.random.RandomState(2).rand(1, 21, 37, 3).astype(np.float32)
    out = model.test(x)
    assert out.shape == x.shape and np.isfinite(out).all()
    padded = np.pad(x, ((0, 0), (0, 3), (0, 3), (0, 0)), mode="reflect")
    want = twm.wavemamba_apply(model.model, torch.from_numpy(padded))[:, :21, :37].numpy()
    np.testing.assert_array_equal(out, want)
    with pytest.raises(NotImplementedError, match="inference only"):
        build_model({**opt, "is_train": True, "train": {"optim_g": {"lr": 1e-3}}})


class FakeCuda:
    """A CPU tensor that claims the CUDA device type, so a CPU-only host
    reaches the entry points' CUDA path (nothing there reads its data)."""

    def __init__(self, t):
        self.t = t
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("cuda", 0)
        self.requires_grad = False

    def dim(self):
        return self.t.dim()

    def numel(self):
        return self.t.numel()

    def is_contiguous(self):
        return self.t.is_contiguous()

    def reshape(self, *shape):
        return FakeCuda(self.t.reshape(*shape))


@pytest.mark.parametrize("entry", ["fused_chain", "fused_chain_band"])
def test_chain_kernel_needs_a_card(entry, monkeypatch):
    """A chain on the CUDA device type passes every check and reaches the
    kernel's loader, which raises on a host without CUDA: no fallback to the
    plain version, no count. Weights on another device are refused first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(tcf, entry)
    w, b = torch.rand(8, 8, 1, 1), torch.rand(8)
    x = FakeCuda(torch.rand(1, 8, 6, 6))
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(x, (("pw", FakeCuda(w), FakeCuda(b)), ("act", "silu")))
    with pytest.raises(ValueError, match="weights must be"):
        fn(x, (("pw", w, b),))
    assert fn.launches == before
