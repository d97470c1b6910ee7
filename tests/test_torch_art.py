"""The port's ART (`wavemamba_torch/models/art.py`, the registry in
`models/__init__.py`, the runner around it) against `wavemamba_tpu` on the CPU.

One small config (dim 16, 2 blocks, 2 heads, window 4, interval 4) on a
20x28 input: after the x4 unshuffle the grid is 5x7, so the dense windows
(4x4) and the sparse groups (interval 4) are both padded and both pad masks
are live. The weights are a seeded `init_art` of the JAX package carried over
by `convert.state_dict_from_jax`. Tolerances: the forward 1e-5 absolute, the
gradients rtol 5e-4 (atol 5e-6), a runner step's loss rtol 1e-5.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch import convert
from wavemamba_torch.models import (
    ART,
    ARTConfig,
    art_forward,
    build_network,
    config_from_opt,
    init_network,
    module_for,
    register_arch,
)
from wavemamba_torch.models import art as tart
from wavemamba_torch.runner import build_model
from wavemamba_tpu import runner as jrunner
from wavemamba_tpu.models import art as jart

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

CFG = {"dim": 16, "n_blocks": 2, "num_heads": 2, "window_size": 4, "interval": 4}


def _jax_params(seed=0):
    p = jart.init_art(jax.random.PRNGKey(seed), jart.ARTConfig(**CFG))
    return jax.tree_util.tree_map(np.asarray, p)


def _image(seed, h=20, w=28, b=2):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    params = _jax_params()
    model = build_network({"type": "ART", **CFG}, convert.state_dict_from_jax(params), device="cpu")
    return params, model


def test_config_matches_jax_defaults():
    assert dataclasses.asdict(ARTConfig()) == dataclasses.asdict(jart.ARTConfig())
    assert ARTConfig().out_dim == jart.ARTConfig().out_dim == 192
    assert tart.NEG_INF == jart.NEG_INF


def test_state_dict_carries_the_jax_tree(pair):
    """Every leaf of `init_art`'s tree lands on a parameter of the module, and
    the module has no other parameter."""
    params, model = pair
    sd = convert.state_dict_from_jax(params)
    assert set(sd) == set(model.state_dict())
    assert "restoration_network.feats.1.attn.pos.pos1.0.weight" in sd
    assert "restoration_network.to_feat.0.weight" in sd


def test_pad_masks_are_live():
    """20x28 at x4 is a 5x7 grid: neither 4 (window) nor 4 (interval) divides it."""
    h, w = 20 // 4, 28 // 4
    assert h % CFG["window_size"] and w % CFG["window_size"] and h % CFG["interval"]


@pytest.mark.parametrize("seed,hw", [(0, (20, 28)), (1, (32, 32)), (2, (8, 12))])
def test_forward_matches_jax(pair, seed, hw):
    """The forward against `art_apply`, masks live (20x28), none (32x32), and a
    grid smaller than the window (8x12: window = min(window, h, w))."""
    params, model = pair
    x = _image(seed, *hw)
    want = np.asarray(jart.art_apply(params, jart.ARTConfig(**CFG), jnp.asarray(x)))
    with torch.no_grad():
        got = art_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_relative_bias_matches_jax(pair):
    """The dynamic position bias of a sparse group whose grid is not square."""
    params, model = pair
    attn = model.restoration_network.feats[0].attn
    want = np.asarray(jart._relative_bias(params["restoration_network"]["feats"][0]["attn"]["pos"],
                                          3, 5, CFG["num_heads"]))
    with torch.no_grad():
        got = attn.relative_bias(3, 5, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_gradients_match_jax(pair):
    """Every parameter's gradient of a squared-error loss against `jax.grad`."""
    params, model = pair
    x, gt = _image(3), _image(4)
    cfg = jart.ARTConfig(**CFG)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jnp.mean((jart.art_apply(p, cfg, jnp.asarray(x)) - jnp.asarray(gt)) ** 2))(params)
    want = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    model = build_network({"type": "ART", **CFG}, convert.state_dict_from_jax(params), device="cpu")
    model.train()
    loss = ((art_forward(model, torch.from_numpy(x)) - torch.from_numpy(gt)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=5e-4, atol=5e-6,
                                   err_msg=name)


def _opt(tmp_path, is_train=True):
    return {"name": "art", "model_type": "FeMaSRModel", "manual_seed": 0, "is_train": is_train,
            "device": "cpu", "network_g": {"type": "ART", **CFG},
            "path": {"models": str(tmp_path / "models"),
                     "training_states": str(tmp_path / "states")},
            "train": {"optim_g": {"lr": 1e-3}, "total_iter": 10,
                      "pixel_opt": {"loss_weight": 1.0}, "fft_opt": {"loss_weight": 0.1}},
            "val": {"metrics": {"psnr": {"type": "psnr", "crop_border": 0,
                                         "test_y_channel": False}}}}


def test_runner_step_matches_jax_runner(tmp_path, monkeypatch):
    """One `RestorationModel` step (L1 + FFT) from the same weights and batch
    as the JAX runner's: the loss rtol 1e-5, and the test route's output
    after the step within 1e-5 of JAX's."""
    jopt = _opt(tmp_path)
    # The JAX runner's `get_root_logger` turns the `wavemamba_tpu` logger's
    # propagation off for the whole process: put it back after this test, so
    # that a later test's caplog still hears that logger.
    monkeypatch.setattr(logging.getLogger("wavemamba_tpu"), "propagate",
                        logging.getLogger("wavemamba_tpu").propagate)
    jmodel = jrunner.build_model(jopt)
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.state["params"]))
    torch.save({"params": sd}, tmp_path / "w.pth")
    opt = _opt(tmp_path)
    opt["path"]["pretrain_network_g"] = str(tmp_path / "w.pth")
    model = build_model(opt)
    assert isinstance(model.model, ART) and model.cfg == ARTConfig(**CFG)
    rs = np.random.RandomState(5)
    batch = {"lq": rs.rand(2, 16, 24, 3).astype(np.float32),
             "gt": rs.rand(2, 16, 24, 3).astype(np.float32)}
    want = float(jmodel.optimize_parameters(batch)["total"])
    got = float(model.optimize_parameters(batch)["total"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    x = rs.rand(1, 21, 27, 3).astype(np.float32)  # pads to x8 and crops back
    np.testing.assert_allclose(model.test(x), jmodel.test(x), atol=1e-5, rtol=0)


def test_uhd_model_keeps_refusing_one_output(tmp_path):
    opt = _opt(tmp_path)
    opt["model_type"] = "UHDModel"
    model = build_model(opt)
    batch = {"lq": np.zeros((1, 16, 16, 3), np.float32), "gt": np.zeros((1, 16, 16, 3), np.float32)}
    with pytest.raises(TypeError, match="two outputs"):
        model.optimize_parameters(batch)


def test_registry_resolution(tmp_path):
    """`type:` resolves through the built-in factories, then ARCH_REGISTRY; a
    WaveMamba knob is no ART key; the config picks the module and the init."""
    from wavemamba_torch.utils.registry import ARCH_REGISTRY

    assert config_from_opt({"type": "ART"}) == ARTConfig()
    assert config_from_opt({"type": "ART", "n_blocks": 3}).n_blocks == 3
    with pytest.raises(KeyError, match="unknown network_g key 'remat'"):
        config_from_opt({"type": "ART", "remat": True})
    with pytest.raises(KeyError, match="Unknown arch type 'Nope'"):
        config_from_opt({"type": "Nope"})
    assert module_for(ARTConfig()) is ART
    model = init_network({"type": "ART", **CFG}, torch.Generator().manual_seed(0), device="cpu")
    assert model.training and isinstance(model, ART)
    same = init_network({"type": "ART", **CFG}, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 same.state_dict().values()))

    @dataclasses.dataclass(frozen=True)
    class TinyConfig:
        width: int = 4
        module_fn = staticmethod(lambda cfg: torch.nn.Conv2d(3, 3, 1))
        init_fn = staticmethod(lambda m, g: m)

    name = "TinyArchForTest"
    if name not in ARCH_REGISTRY:
        ARCH_REGISTRY.register(lambda **kw: TinyConfig(**kw), name=name)
    assert config_from_opt({"type": name, "width": 2}) == TinyConfig(2)
    assert isinstance(init_network({"type": name}, torch.Generator(), device="cpu"),
                      torch.nn.Conv2d)

    @register_arch("ARTTiny")
    def _tiny(**kw):
        return ARTConfig(**{**CFG, **kw})

    assert config_from_opt({"type": "ARTTiny"}) == ARTConfig(**CFG)
