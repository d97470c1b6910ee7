"""`WaveMambaConfig.conv1x1_as_conv` and the 1x1 lowering rule of the port's
`Conv2d` against wavemamba_tpu on the CPU.

The JAX package's `conv2d` computes a 1x1 conv with stride 1, one group and
no padding as a token matmul whenever its input is not float32, unless the
call site opts out (`as_conv`, set per region by `conv1x1_as_conv`: 'ffn'
the LFSS FFN's conv1 / conv3, 'hfe' the HFE blocks' qkv, PAConv k2 and
FeedForward 1x1s). The port's `Conv2d` takes the same rule. Held here: the
rule at one layer (JAX's bits), float32 untouched under every variant, the
sites that stay convs counted against the 1x1 `conv_general_dilated` of
JAX's bf16 jaxpr, and each bf16 variant of the whole model against JAX's
same variant. Weights cross over through `state_dict_from_jax`; inputs are
made with numpy.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavemamba_torch import convert
from wavemamba_torch.models import build_network
from wavemamba_torch.models import wavemamba as twm
from wavemamba_torch.ops.nn import Conv2d
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.ops import nn as jnn

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SMALL = dict(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
VARIANTS = [(), ("ffn",), ("hfe",), ("ffn", "hfe")]
# Six LFSS blocks at this depth with two FFN 1x1s each; six HFE blocks with
# five 1x1s each under 'hfe' (qkv, two PAConv k2, FeedForward's two).
SITES = {(): 0, ("ffn",): 12, ("hfe",): 30, ("ffn", "hfe"): 42}
PSNR_FLOOR = 45.0
BF16_STEP = 2.0 ** -7


def _psnr(a, b):
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2)))


@functools.lru_cache(maxsize=None)
def _params():
    return jwm.init_wavemamba(jax.random.PRNGKey(0), jwm.WaveMambaConfig(**SMALL))


def _model(cfg):
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, _params()))
    return build_network({"type": "WaveMamba", **dataclasses.asdict(cfg)}, sd, device="cpu")


def _input(h=32, w=32):
    return np.random.RandomState(0).rand(1, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("cin,cout,bias", [(32, 64, True), (64, 32, True), (32, 4, False)])
def test_1x1_lowering_gives_jax_bits(cin, cout, bias):
    """One 1x1 layer in bf16, matmul lowering on both sides: JAX's bits but
    where the two sums round apart (at most one bf16 step, on at most 1e-3 of
    the elements; measured 0 to 6.5e-5). float32 keeps the conv on both
    sides and agrees to float32 rounding."""
    rs = np.random.RandomState(cin + cout)
    x = rs.randn(2, 12, 20, cin).astype(np.float32)
    w = (rs.randn(1, 1, cin, cout) * 0.2).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    params = {"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if bias else {})}
    m = Conv2d(cin, cout, 1, bias=bias)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))))
        if bias:
            m.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert m.lowers_to_matmul(xt.to(dtype)) == (dtype != torch.float32)
        with torch.no_grad():
            got = m(xt.to(dtype)).float().numpy().transpose(0, 2, 3, 1)
        want = np.asarray(jnn.conv2d(params, jnp.asarray(x).astype(jdtype)).astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            continue
        diff = np.abs(got - want)
        assert np.all(diff <= BF16_STEP * np.abs(want)), diff.max()
        assert np.mean(diff > 0) <= 1e-3, np.mean(diff > 0)


def test_opted_out_and_strided_1x1_stay_convs():
    """`as_conv`, a stride, groups or padding keep the conv, as JAX's rule does."""
    x = torch.rand(1, 8, 6, 6).bfloat16()
    assert Conv2d(8, 8, 1).lowers_to_matmul(x)
    for m in (Conv2d(8, 8, 1, as_conv=True), Conv2d(8, 8, 1, stride=2), Conv2d(8, 8, 1, groups=2),
              Conv2d(8, 8, 1, padding=1), Conv2d(8, 8, 3, padding=1)):
        assert not m.lowers_to_matmul(x)


def test_float32_forward_keeps_its_bits_under_every_variant():
    """float32 keeps every conv, whatever `conv1x1_as_conv` says: the four
    variants give the same bits as each other and as a model whose every
    Conv2d is opted out (the lowering before the rule)."""
    x = torch.from_numpy(_input())
    outs = [twm.wavemamba_apply(_model(twm.WaveMambaConfig(**SMALL, conv1x1_as_conv=v)), x)
            for v in VARIANTS]
    all_conv = _model(twm.WaveMambaConfig(**SMALL))
    for m in all_conv.modules():
        if isinstance(m, Conv2d):
            m.as_conv = True
    outs.append(twm.wavemamba_apply(all_conv, x))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def _jaxpr_1x1_convs(jaxpr):
    """The 1x1 `conv_general_dilated` equations of a jaxpr, sub-jaxprs included."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            spatial = eqn.params["dimension_numbers"].rhs_spec[2:]
            shape = eqn.invars[1].aval.shape
            n += all(shape[d] == 1 for d in spatial)
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else (value,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    n += _jaxpr_1x1_convs(sub)
    return n


def _port_1x1_convs(model, x, monkeypatch):
    """The F.conv2d calls with a 1x1 kernel on bf16 input of one forward of
    `model` (on the CPU the fused chains' plain version sums its products in
    float64 through F.conv2d: those calls stand for the chain kernel's)."""
    seen = []
    real = F.conv2d

    def conv2d(inp, weight, *args, **kwargs):
        if weight.shape[-2:] == (1, 1) and inp.dtype != torch.float64:
            seen.append(inp.dtype)
        return real(inp, weight, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d)
    twm.wavemamba_apply(model, torch.from_numpy(x))
    monkeypatch.setattr(torch.nn.functional, "conv2d", real)
    return seen


@pytest.mark.parametrize("conv_impl", ["xla", "fused"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_conv_sites_match_jax_jaxpr(variant, conv_impl, monkeypatch):
    """In bf16 the port runs as many 1x1 sites as F.conv2d as JAX's jaxpr holds
    1x1 convs: the regions' sites under 'xla' (`SITES`), none under the fused
    chains, which take the regions' 1x1s into their own products."""
    x = _input()
    jcfg = jwm.WaveMambaConfig.fast_tpu(**SMALL, conv1x1_as_conv=variant, conv_impl=conv_impl)
    jaxpr = jax.make_jaxpr(lambda p, t: jwm.wavemamba_apply(p, jcfg, t))(_params(), x)
    want = _jaxpr_1x1_convs(jaxpr.jaxpr)
    tcfg = twm.WaveMambaConfig.fast(**SMALL, conv1x1_as_conv=variant, conv_impl=conv_impl)
    assert tcfg.conv1x1_as_conv == jcfg.conv1x1_as_conv
    seen = _port_1x1_convs(_model(tcfg), x, monkeypatch)
    assert len(seen) == want == (SITES[variant] if conv_impl == "xla" else 0)
    assert set(seen) <= {torch.bfloat16}


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_variant_matches_jax_variant(variant):
    """The whole model under `fast(conv1x1_as_conv=variant)` against JAX's
    `fast_tpu(conv1x1_as_conv=variant)` (its fused scan in Pallas interpret
    mode): the PSNR floor of `test_torch_fast.py`, 45 dB. Measured at this
    size 55.1 / 51.5 / 55.2 / 51.7 dB for (), ffn, hfe, ffn+hfe; each is as far
    from the float32 model (55.1 / 51.7 / 55.1 / 51.8), so the distance is the
    bf16 noise of the network, not the lowering (the all-conv lowering of
    the parent tree read 51.4 dB for ())."""
    x = _input()
    jcfg = jwm.WaveMambaConfig.fast_tpu(**SMALL, conv1x1_as_conv=variant)
    want = np.asarray(jax.jit(lambda p, t: jwm.wavemamba_apply(p, jcfg, t))(_params(), x))
    got = twm.wavemamba_apply(_model(twm.WaveMambaConfig.fast(**SMALL, conv1x1_as_conv=variant)),
                              torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _psnr(got.numpy(), want) >= PSNR_FLOOR, _psnr(got.numpy(), want)
