"""The bf16 presets of the port (`WaveMambaConfig.fast()`, `fast_xla()`,
`fast_train()`) and their pieces against wavemamba_tpu on the CPU.

JAX parameters cross over through `state_dict_from_jax`; inputs are made with
numpy. The JAX side runs its presets' field values: `fast_tpu()` (its
`fast()` turns into `fast_xla()` off a TPU) with the fused kernel in Pallas
interpret mode, and the kernel preset for training, which its `fast_train()`
gives on a TPU. Both sides compute in bf16 with float32 statistics and scan
state, but round at other places (fused conv biases, summation orders), and a
flip of a bf16 value travels through the network; so the whole model is held
to a PSNR floor between the two outputs, 45 dB (measured 54.3 dB for `fast()`
and 54.9 dB for `fast_xla()` at the size below; each is 53-55 dB from the
float32 model), and training to a relative loss tolerance. Since a float32
model clears that floor too, the dtype of every layer's input and output is
checked on its own, under each preset.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch import convert
from wavemamba_torch.models import build_network, config_from_opt
from wavemamba_torch.models import wavemamba as twm
from wavemamba_torch.ops.haar import dwt2, dwt2_conv
from wavemamba_torch.ops.nn import Conv2d, LayerNorm, Linear, PReLU
from wavemamba_torch.train import trainer as ttrain
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.ops import haar as jhaar
from wavemamba_tpu.train import trainer as jtrain

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
PSNR_FLOOR = 45.0
BF16_STEP = 2.0 ** -7  # one bf16 step (8 significant bits), at most this share of the value


def _psnr(a, b):
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).to(dtype)


def _nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


@functools.lru_cache(maxsize=None)
def _params():
    return jwm.init_wavemamba(jax.random.PRNGKey(0), jwm.WaveMambaConfig(**SMALL))


def _state_dict():
    return convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, _params()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dwt2_conv_matches_jax(dtype):
    """The conv form of the DWT: float32 within its rounding of the slicing
    form and of JAX's; bf16 rounds each subband once, as JAX's conv does, and
    gives its bits (measured: equal), where the slicing form rounds after
    every add."""
    x = np.random.RandomState(0).randn(2, 12, 20, 5).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = dwt2_conv(_nchw(x, tdt))
    want = jhaar.dwt2_conv(jnp.asarray(x).astype(jdt))
    slicing = dwt2(_nchw(x, tdt))
    for g, w, s in zip(got, want, slicing):
        assert g.dtype == tdt and g.shape == (2, 5, 6, 10)
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(_nhwc(g), w, rtol=0, atol=1e-6)
            np.testing.assert_allclose(_nhwc(s), w, rtol=0, atol=1e-6)
        else:
            assert (np.abs(_nhwc(g) - w) <= BF16_STEP * np.abs(w)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [2, 4, 8])
def test_ps_down_matches_jax(r, dtype):
    """Pixel-unshuffle + 1x1 as one r x r stride-r conv: float32 equals the
    stock modules' two steps and JAX's conv to its rounding; bf16 is within
    one bf16 step of JAX's (both sum in float32, in other orders)."""
    rs = np.random.RandomState(r)
    x = rs.rand(1, 16, 24, 3).astype(np.float32)
    conv = Conv2d(3 * r * r, 8, 1)
    torch.nn.init.uniform_(conv.weight, -0.3, 0.3)
    torch.nn.init.uniform_(conv.bias, -0.3, 0.3)
    p = {"w": jnp.asarray(conv.weight.detach().numpy()[:, :, 0, 0].T[None, None]),
         "b": jnp.asarray(conv.bias.detach().numpy())}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with torch.no_grad():
        got = twm._ps_down(conv, _nchw(x, tdt), r)
        stock = conv(torch.nn.PixelUnshuffle(r)(_nchw(x)))
    want = np.asarray(jwm._ps_down(p, jnp.asarray(x).astype(jdt), r).astype(jnp.float32))
    assert got.dtype == tdt and got.shape == (1, 8, 16 // r, 24 // r)
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(_nhwc(stock), want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(_nhwc(got) - want) <= BF16_STEP * np.abs(want) + BF16_STEP * 2 ** -4).all()


def test_presets_have_the_jax_field_values():
    """The port's classmethods set what the JAX ones set; the port's `fast()`
    is `fast_tpu()` on every device (no backend switch)."""
    fields = ("scan_impl", "scan_chunk", "scan_sub", "compute_dtype", "scan_dtype", "conv_impl")
    for name in ("fast_tpu", "fast_xla"):
        j, t = getattr(jwm.WaveMambaConfig, name)(), getattr(twm.WaveMambaConfig, name)()
        assert all(getattr(j, f) == getattr(t, f) for f in fields), name
    assert twm.WaveMambaConfig.fast() == twm.WaveMambaConfig.fast_tpu()
    t = twm.WaveMambaConfig.fast_train()
    assert (t.scan_impl, t.scan_chunk, t.compute_dtype, t.scan_dtype) == \
        ("pallas_fused", 128, "bfloat16", "bfloat16")
    assert twm.WaveMambaConfig.fast(wf=16).wf == 16
    f = twm.WaveMambaConfig.fast(conv_impl="fused")  # raised before the chains took bf16
    assert (f.conv_impl, f.compute_dtype, f.scan_dtype) == ("fused", "bfloat16", "bfloat16")


@pytest.mark.parametrize("jax_preset,port_preset", [("fast_tpu", "fast"), ("fast_xla", "fast_xla")])
def test_model_matches_jax_preset(jax_preset, port_preset):
    x = np.random.RandomState(0).rand(1, 32, 48, 3).astype(np.float32)
    jcfg = getattr(jwm.WaveMambaConfig, jax_preset)(**SMALL)
    want = np.asarray(jax.jit(lambda p, x: jwm.wavemamba_apply(p, jcfg, x))(_params(), x))
    tcfg = getattr(twm.WaveMambaConfig, port_preset)(**SMALL)
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(tcfg)}, _state_dict(), device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = twm.wavemamba_apply(model, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _psnr(got.numpy(), want) >= PSNR_FLOOR, _psnr(got.numpy(), want)


def test_fast_forward_routes_bf16_streams_through_the_pair_scan():
    """Under `fast()` every SS2D hands the pair scan bf16 tokens and asks for
    bf16 y (the streams K1 takes on the card): 12 calls at this depth."""
    tcfg = twm.WaveMambaConfig.fast(**SMALL)
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(tcfg)}, _state_dict(), device="cpu")
    calls = []

    def scan(x, *args, out_dtype=None):
        calls.append((x.dtype, out_dtype))
        return twm.ss2d_scan_pair(x, *args, out_dtype=out_dtype)

    twm.set_scan(model, scan)
    twm.wavemamba_apply(model, torch.rand(1, 16, 24, 3))
    assert calls == [(torch.bfloat16, torch.bfloat16)] * 12


@pytest.mark.parametrize("preset", ["fast", "fast_xla", "fast_train"])
def test_every_layer_runs_in_bf16_under_the_presets(monkeypatch, preset):
    """The bf16 policy layer by layer, which the PSNR floor cannot see (a
    float32 model is 53-55 dB from each preset): every conv, linear, PReLU
    and LayerNorm of the model runs, and each takes and gives bf16; the DWT
    and the pixel-unshuffle pyramid take their conv forms (`dwt2_conv`, and
    `_ps_down`, which runs the pyramid's 1x1s through their weights).
    `fast_train` through one training step."""
    forms, ps_convs = [], {}
    real_ps_down = twm._ps_down

    def ps_down(conv, x, r):
        out = real_ps_down(conv, x, r)
        ps_convs[id(conv)] = (x.dtype, out.dtype)
        return out

    monkeypatch.setattr(twm, "dwt2_conv", lambda x: forms.append(x.dtype) or dwt2_conv(x))
    monkeypatch.setattr(twm, "_ps_down", ps_down)
    tcfg = getattr(twm.WaveMambaConfig, preset)(**SMALL, remat=False)
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(tcfg)}, _state_dict(), device="cpu")
    layers = [m for m in model.modules() if isinstance(m, (Conv2d, Linear, PReLU, LayerNorm))]
    seen = {}
    for m in layers:
        m.register_forward_hook(lambda mod, inputs, out: seen.setdefault(
            id(mod), set()).add((type(mod).__name__, inputs[0].dtype, out.dtype)))
    if preset == "fast_train":
        state = ttrain.create_train_state(model, ttrain.TrainConfig())
        lq, gt = _batch(3)
        ttrain.make_train_step(ttrain.TrainConfig())(state, torch.from_numpy(lq), torch.from_numpy(gt))
    else:
        twm.wavemamba_apply(model, torch.rand(1, 32, 48, 3))
    assert len(layers) > 100 and len(ps_convs) == 3
    assert set(seen) | set(ps_convs) == {id(m) for m in layers} and not set(seen) & set(ps_convs)
    kinds = set().union(*seen.values())
    assert {k for k, _, _ in kinds} == {"Conv2d", "Linear", "PReLU", "LayerNorm"}
    assert {(i, o) for _, i, o in kinds} | set(ps_convs.values()) == {(torch.bfloat16, torch.bfloat16)}
    assert forms and set(forms) == {torch.bfloat16}


def _batch(seed, b=2, h=32, w=32):
    rs = np.random.RandomState(seed)
    gt = rs.rand(b, h, w, 3).astype(np.float32)
    lq = np.clip(gt * 0.12 + rs.randn(b, h, w, 3).astype(np.float32) * 0.01, 0, 1)
    return lq.astype(np.float32), gt


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "float32"])
def test_three_bf16_train_steps_match_jax(scan_dtype):
    """`fast_train()` without remat, EMA on: the kernel preset on both sides
    (the JAX fused kernel and its backward in interpret mode; the port's
    plain versions of K1 and K2), float32 parameters, AdamW state and loss.
    Per-step loss relative 2e-3 (measured 1e-4 to 2.8e-4; JAX's bf16 loss is
    7e-4 from its float32 loss by step 3). `scan_dtype` float32 is the proc
    ymls' mix: bf16 compute, bf16 tokens into the scan, float32 y and dy."""
    sched = {"type": "CosineAnnealingRestartCyclicLR", "periods": [100, 100000],
             "restart_weights": [1, 1], "eta_mins": [0.0005, 0.0000001]}
    tkw = dict(lr=5e-4, weight_decay=1e-3, betas=(0.9, 0.99), scheduler=sched, pixel_weight=1.0,
               fft_weight=0.1, ema_decay=0.999)
    jcfg = jwm.WaveMambaConfig(**SMALL, remat=False, scan_impl="pallas_fused", scan_chunk=128,
                               compute_dtype="bfloat16", scan_dtype=scan_dtype)
    jstate = jtrain.create_train_state(jax.tree_util.tree_map(jnp.array, _params()),
                                       jtrain.TrainConfig(**tkw))
    jstep = jtrain.make_train_step(jcfg, jtrain.TrainConfig(**tkw))
    tcfg = twm.WaveMambaConfig.fast_train(**SMALL, remat=False, scan_dtype=scan_dtype)
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(tcfg)}, _state_dict(), device="cpu")
    state = ttrain.create_train_state(model, ttrain.TrainConfig(**tkw))
    step = ttrain.make_train_step(ttrain.TrainConfig(**tkw))
    for i in range(3):
        lq, gt = _batch(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(lq), jnp.asarray(gt))
        state, m = step(state, torch.from_numpy(lq), torch.from_numpy(gt))
        np.testing.assert_allclose(float(m["total"]), float(jm["total"]), rtol=2e-3, err_msg=f"step {i}")
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(v.dtype == torch.float32 for v in state.ema.values())
    assert state.step == 3


def test_the_xxl4_yml_network_builds_bf16():
    """The shipped bf16 yml's `network_g` (scan_chunk 128, bf16 and bf16)
    builds without forcing, into the `fast_train()` preset."""
    cfg = config_from_opt({"type": "WaveMamba", "in_chn": 3, "wf": 32, "n_l_blocks": [1, 2, 4],
                           "n_h_blocks": [1, 1, 2], "ffn_scale": 2.0, "scan_impl": "pallas_fused",
                           "scan_chunk": 128, "compute_dtype": "bfloat16", "scan_dtype": "bfloat16"})
    assert cfg == twm.WaveMambaConfig.fast_train()


class _RecordingScan:
    """A `set_scan` route that records the dtype of each call's tokens, the
    `out_dtype` asked for and y's dtype, and passes the call on to the port's
    `ss2d_scan_pair` (its plain version on the CPU)."""

    def __init__(self):
        from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

        self.scan, self.calls = ss2d_scan_pair, []

    def __call__(self, x, *args, out_dtype=None):
        y = self.scan(x, *args, out_dtype=out_dtype)
        self.calls.append((x.dtype, out_dtype, y.dtype))
        return y


@pytest.mark.parametrize("yml", ["train_wavemamba_proc.yml", "train_wavemamba_proc512.yml"])
def test_the_proc_ymls_scan_bf16_tokens_into_float32_y(yml):
    """The proc and proc512 ymls set `compute_dtype: bfloat16` and no
    `scan_dtype`, so float32: `SS2D._fused` hands the scan bf16 tokens and
    asks for float32 y, the (bf16, float32) pair that K1 and K2 are built for.
    A forward of the yml's full-width network at 32x48 through a recording
    scan shows the mix in every one of its 28 calls."""
    from wavemamba_torch.models import init_network
    from wavemamba_torch.utils.options import yaml_load

    opt = yaml_load(os.path.join(REPO, "options", yml))["network_g"]
    cfg = config_from_opt(opt)
    assert (cfg.compute_dtype, cfg.scan_dtype, cfg.scan_impl) == ("bfloat16", "float32", "pallas_fused")
    assert (cfg.remat, cfg.remat_policy) == (True, "save_scan")  # the ymls train with recompute
    model = init_network({**opt, "remat": False}, torch.Generator().manual_seed(5), device="cpu",
                         train=False)
    scan = _RecordingScan()
    twm.set_scan(model, scan)
    with torch.no_grad():
        out = twm.wavemamba_apply(model, torch.rand(1, 32, 48, 3))
    assert out.shape == (1, 32, 48, 3) and bool(torch.isfinite(out).all())
    assert scan.calls == [(torch.bfloat16, torch.float32, torch.float32)] * 28
