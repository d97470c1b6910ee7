"""The port's training path (`wavemamba_torch/losses`, `train/`, the model's
initialiser and remat, `checkpoint.py`, `convert.train_state_from_jax`)
against wavemamba_tpu on the CPU.

Inputs are made with numpy; JAX parameters cross over through
`state_dict_from_jax`. The JAX side is kept small (wf=16, one block per
level, 32x32, batch 2, no remat, `scan_impl='chunked'` in float32, which
computes the same function as the fused kernel) because its jit compiles
dominate. Tolerances are stated where they are used, with what was measured.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch import checkpoint as tckpt
from wavemamba_torch import convert
from wavemamba_torch import losses as tlosses
from wavemamba_torch.models import WaveMambaConfig, build_network, init_network, param_count
from wavemamba_torch.models import wavemamba as twm
from wavemamba_torch.train import schedules as tsched
from wavemamba_torch.train import trainer as ttrain
from wavemamba_tpu import losses as jlosses
from wavemamba_tpu.convert.torch_import import load_wavemamba_checkpoint
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.train import schedules as jsched
from wavemamba_tpu.train import trainer as jtrain

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


SMALL = dict(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
OPT = {"type": "WaveMamba", **SMALL, "remat": False}
SCHEDULER = {"type": "CosineAnnealingRestartCyclicLR", "periods": [100, 100000],
             "restart_weights": [1, 1], "eta_mins": [0.0005, 0.0000001]}
TCFG = dict(lr=5e-4, weight_decay=1e-3, betas=(0.9, 0.99), scheduler=SCHEDULER,
            pixel_weight=1.0, fft_weight=0.1, ema_decay=0.999, grad_clip=0.5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=2, h=32, w=32):
    """gt uniform, lq = gt * 0.12 + noise: a seeded low-light pair, NHWC."""
    rs = np.random.RandomState(seed)
    gt = rs.rand(b, h, w, 3).astype(np.float32)
    lq = np.clip(gt * 0.12 + rs.randn(b, h, w, 3).astype(np.float32) * 0.01, 0, 1)
    return lq.astype(np.float32), gt


# --------------------------------------------------------------------------- losses

def _pair(seed=0, shape=(2, 24, 40, 3)):
    rs = np.random.RandomState(seed)
    return rs.rand(*shape).astype(np.float32), rs.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("name,kw,rtol", [
    ("l1_loss", {}, 0), ("l1_loss", {"reduction": "sum", "loss_weight": 0.5}, 1e-6),
    ("mse_loss", {}, 0), ("charbonnier_loss", {"eps": 1e-6}, 0),
    ("psnr_loss", {}, 0), ("psnr_loss", {"to_y": True, "loss_weight": 0.5}, 0),
    ("fft_loss", {"loss_weight": 0.1}, 1e-5), ("ssim", {}, 1e-5), ("ssim_loss", {}, 1e-5),
])
def test_loss_matches_jax(name, kw, rtol):
    """atol 1e-6 on values of order 0.1-30; `fft_loss`, `ssim` and the sum
    reduction (order 1e3) rtol 1e-5 / 1e-6: another summation order."""
    p, t = _pair()
    want = float(getattr(jlosses, name)(jnp.asarray(p), jnp.asarray(t), **kw))
    got = float(getattr(tlosses, name)(torch.from_numpy(p), torch.from_numpy(t), **kw))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def test_weighted_losses_match_jax():
    """The weighted mean (a weight that broadcasts over channels) and the TV
    loss with and without a weight."""
    p, t = _pair(1)
    w = np.random.RandomState(2).rand(2, 24, 40, 1).astype(np.float32)
    for name in ("l1_loss", "mse_loss", "charbonnier_loss"):
        want = float(getattr(jlosses, name)(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w)))
        got = float(getattr(tlosses, name)(*map(torch.from_numpy, (p, t, w))))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for weight in (None, w):
        jw = None if weight is None else jnp.asarray(weight)
        tw = None if weight is None else torch.from_numpy(weight)
        want = float(jlosses.weighted_tv_loss(jnp.asarray(p), jw))
        got = float(tlosses.weighted_tv_loss(torch.from_numpy(p), tw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    none = tlosses.l1_loss(torch.from_numpy(p), torch.from_numpy(t), reduction="none")
    np.testing.assert_allclose(none.numpy(), np.abs(p - t), atol=1e-7)
    with pytest.raises(ValueError, match="reduction"):
        tlosses.l1_loss(torch.from_numpy(p), torch.from_numpy(t), reduction="median")


@pytest.mark.parametrize("fft_weight", [0.0, 0.1])
def test_uhd_loss_matches_jax(fft_weight):
    """The 1/8 ground truth is an antialiased bilinear resize on both sides."""
    out, gt = _pair(3, (2, 32, 48, 3))
    out8 = np.random.RandomState(4).rand(2, 4, 6, 3).astype(np.float32)
    want, wm = jlosses.uhd_loss(*map(jnp.asarray, (out, out8, gt)), fft_weight=fft_weight)
    got, gm = tlosses.uhd_loss(*map(torch.from_numpy, (out, out8, gt)), fft_weight=fft_weight)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_build_loss():
    p, t = map(torch.from_numpy, _pair(5))
    fn = tlosses.build_loss({"type": "FFTLoss", "loss_weight": 0.1, "reduction": "mean"})
    assert float(fn(p, t)) == float(tlosses.fft_loss(p, t, loss_weight=0.1))
    fn = tlosses.build_loss({"type": "PSNRLoss", "toY": True})
    assert float(fn(p, t)) == float(tlosses.psnr_loss(p, t, to_y=True))
    # the GAN suite is in the registry (tests/test_torch_gan_losses.py holds it to JAX)
    fn = tlosses.build_loss({"type": "GANLoss", "gan_type": "lsgan", "loss_weight": 0.5})
    assert float(fn(p, True)) == float(tlosses.gan_loss(p, True, gan_type="lsgan", loss_weight=0.5))
    with pytest.raises(KeyError, match="Unknown loss type 'NopeLoss'"):
        tlosses.build_loss({"type": "NopeLoss"})


# ------------------------------------------------------------------------ schedules

@pytest.mark.parametrize("opt,steps", [
    (SCHEDULER, [0, 1, 50, 99, 100, 101, 5000, 100099, 100100, 100101, 200000]),
    ({"type": "CosineAnnealingRestartLR", "periods": [10, 20], "restart_weights": [1, 0.5],
      "eta_min": 1e-6}, [0, 5, 9, 10, 11, 20, 29, 30, 31]),
    ({"type": "MultiStepRestartLR", "milestones": [5, 10, 25], "gamma": 0.5,
      "restarts": [0, 20], "restart_weights": [1, 0.5]}, [0, 4, 5, 6, 10, 19, 20, 21, 25, 26]),
    ({"type": "MultiStepLR", "milestones": [3, 6]}, [0, 2, 3, 6, 7]),
])
def test_schedule_matches_jax(opt, steps):
    """At 0, at every period boundary and one step either side, and
    mid-period. The JAX closures compute in float32: rtol 1e-5."""
    want = jsched.build_scheduler(opt, 5e-4)
    got = tsched.build_scheduler(opt, 5e-4)
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-5, atol=1e-12, err_msg=str(s))


def test_warmup_matches_jax():
    tcfg = dict(lr=5e-4, scheduler=SCHEDULER, warmup_iter=10)
    _, want = jtrain.make_optimizer(jtrain.TrainConfig(**tcfg))
    got = ttrain.make_lr(ttrain.TrainConfig(**tcfg))
    for s in (0, 1, 8, 9, 10, 11, 99, 100, 101):
        np.testing.assert_allclose(got(s), float(want(jnp.asarray(s))), rtol=1e-5, err_msg=str(s))
    assert ttrain.make_lr(ttrain.TrainConfig(lr=1e-3)) == 1e-3
    with pytest.raises(KeyError, match="Unknown scheduler"):
        tsched.build_scheduler({"type": "Nope"}, 1e-3)
    with pytest.raises(ValueError, match="one entry per cycle"):
        tsched.cosine_annealing_restart_cyclic(1e-3, [10, 20], eta_mins=[0.0])


# ------------------------------------------------------------------ trainer vs JAX

@functools.lru_cache(maxsize=None)
def _jax_run():
    """Four steps of the JAX trainer from a seeded init: the numpy state
    before step 0, after step 3 and after step 4, every step's metrics, and
    loss and gradients at step 0."""
    cfg = jwm.WaveMambaConfig(**SMALL, remat=False, scan_impl="chunked")
    tcfg = jtrain.TrainConfig(**TCFG)
    params = jwm.init_wavemamba(jax.random.PRNGKey(0), cfg)
    batches = [_batch(10 + i) for i in range(4)]
    (loss0, _), grads0 = jax.jit(jax.value_and_grad(
        lambda p, lq, gt: jtrain.loss_fn(p, cfg, tcfg, lq, gt), has_aux=True))(params, *batches[0])
    state = jtrain.create_train_state(params, tcfg)
    step = jtrain.make_train_step(cfg, tcfg)
    states, metrics = [_np_tree(state)], []
    for lq, gt in batches:
        state, m = step(state, jnp.asarray(lq), jnp.asarray(gt))
        states.append(_np_tree(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(batches=batches, loss0=float(loss0), grads0=_np_tree(grads0), states=states,
                metrics=metrics)


def _torch_state(jax_state, **tcfg_kw):
    tcfg = ttrain.TrainConfig(**{**TCFG, **tcfg_kw})
    model = build_network(OPT, convert.state_dict_from_jax(jax_state["params"]), device="cpu")
    return ttrain.create_train_state(model, tcfg), ttrain.make_train_step(tcfg), tcfg


def _max_diff(named, jax_tree):
    want = convert.state_dict_from_jax(jax_tree)
    return max(float((t.detach() - want[n]).abs().max()) for n, t in named.items())


def test_loss_and_gradients_match_jax():
    """Step 0: loss rtol 1e-5 (measured 4e-7); every parameter's gradient
    rtol 5e-4, atol 5e-5, the JAX package's own bound for its fused backward
    (measured: 3e-7 absolute at worst, 2e-5 of a gradient's own max)."""
    run = _jax_run()
    state, _, tcfg = _torch_state(run["states"][0])
    lq, gt = map(torch.from_numpy, run["batches"][0])
    total, metrics = ttrain.loss_fn(state.model, tcfg, lq, gt)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), run["loss0"], rtol=1e-5)
    assert set(metrics) == {"l1", "fft", "total"}
    want = convert.state_dict_from_jax(run["grads0"])
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_three_train_steps_match_jax():
    """EMA 0.999 and the gradient clip on. Per-step loss rtol 1e-4 (measured
    2.4e-6 at worst). AdamW divides by sqrt(v), so where a gradient is near
    zero a difference in its last bits can move the parameter by up to lr =
    5e-4 a step: parameters and EMA are held to 5e-5 absolute after three
    steps (measured 5.7e-6 for the parameters, 1.4e-6 for the EMA). The clip
    follows optax's rule exactly (`clip_by_global_norm`), not
    `clip_grad_norm_`'s, which adds 1e-6 to the norm."""
    run = _jax_run()
    state, step, _ = _torch_state(run["states"][0])
    for i in range(3):
        lq, gt = map(torch.from_numpy, run["batches"][i])
        state, m = step(state, lq, gt)
        for k, v in run["metrics"][i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-4, err_msg=f"step {i} {k}")
    want = run["states"][3]
    assert state.step == int(want["step"]) == 3
    named = dict(state.model.named_parameters())
    assert _max_diff(named, want["params"]) < 5e-5
    assert _max_diff(state.ema, want["ema"]) < 5e-5
    assert _max_diff(state.ema, want["params"]) > 1e-4  # the EMA lags the parameters


def test_train_state_from_jax_then_one_more_step():
    """Both sides continue from the JAX state after step 3 (parameters,
    Adam's mu/nu/count, EMA, step): the fourth step's loss rtol 1e-5
    (measured 7e-7), parameters and EMA within 1e-5 (measured 4.8e-7 each)."""
    run = _jax_run()
    state, step, _ = _torch_state(run["states"][0])
    sd = convert.train_state_from_jax(run["states"][3])
    assert sd["step"] == 3 and sd["adam_step"] == 3
    state.load_state_dict(sd)
    named = dict(state.model.named_parameters())
    assert _max_diff(named, run["states"][3]["params"]) == 0.0
    assert _max_diff(state.ema, run["states"][3]["ema"]) == 0.0
    state, m = step(state, *map(torch.from_numpy, run["batches"][3]))
    np.testing.assert_allclose(float(m["total"]), run["metrics"][3]["total"], rtol=1e-5)
    assert state.step == 4
    assert _max_diff(named, run["states"][4]["params"]) < 1e-5
    assert _max_diff(state.ema, run["states"][4]["ema"]) < 1e-5
    with pytest.raises(ValueError, match="no Adam state"):
        convert.train_state_from_jax({"step": 0, "params": {}, "opt_state": ()})


def test_ema_lr_and_clip_follow_their_formulas():
    run = _jax_run()
    state, step, tcfg = _torch_state(run["states"][0], warmup_iter=2)
    named = dict(state.model.named_parameters())
    lr = ttrain.make_lr(tcfg)
    for i in range(3):
        ema_before = {n: e.clone() for n, e in state.ema.items()}
        state, _ = step(state, *map(torch.from_numpy, run["batches"][i]))
        assert state.optimizer.param_groups[0]["lr"] == lr(i)  # step counted from 0
        for n, p in named.items():
            torch.testing.assert_close(state.ema[n], ema_before[n] * 0.999 + p.detach() * 0.001,
                                       rtol=1e-6, atol=1e-7)
    assert lr(0) == pytest.approx(5e-4 / 2) and lr(2) == pytest.approx(tsched.build_scheduler(
        SCHEDULER, 5e-4)(2))
    params = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(4))]
    params[0].grad, params[1].grad = torch.full((3,), 2.0), torch.full((4,), -2.0)
    norm = ttrain.clip_by_global_norm(params, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(28.0))
    assert float(torch.cat([p.grad for p in params]).norm()) == pytest.approx(1.0)
    params[0].grad, params[1].grad = torch.full((3,), 0.1), torch.full((4,), 0.1)
    ttrain.clip_by_global_norm(params, 1.0)  # under the limit: untouched
    assert float(params[0].grad[0]) == pytest.approx(0.1)


def test_uint8_batches_and_eval_step():
    """uint8 batches are scaled on the device; the eval step runs without a
    gradient and leaves the model in train mode."""
    run = _jax_run()
    lq, gt = run["batches"][0]
    lq8, gt8 = (np.round(a * 255).astype(np.uint8) for a in (lq, gt))
    a, step, _ = _torch_state(run["states"][0])
    b, _, _ = _torch_state(run["states"][0])
    _, ma = step(a, torch.from_numpy(lq8), torch.from_numpy(gt8))
    _, mb = step(b, torch.from_numpy(lq8.astype(np.float32) / 255),
                 torch.from_numpy(gt8.astype(np.float32) / 255))
    assert float(ma["total"]) == float(mb["total"])
    out = ttrain.make_eval_step()(a.model, torch.from_numpy(lq8))
    assert out.shape == lq.shape and not out.requires_grad and a.model.training
    with pytest.raises(TypeError, match="two outputs"):
        ttrain.loss_fn(a.model, dataclasses.replace(ttrain.TrainConfig(), loss_mode="uhd"),
                       torch.from_numpy(lq), torch.from_numpy(gt))


# ---------------------------------------------------------------------- checkpoints

def test_training_state_round_trip_and_resume(tmp_path):
    """Save after step 2, restore into a fresh trainer with other weights, one
    more step on both: identical loss, parameters, moments and EMA."""
    run = _jax_run()
    state, step, tcfg = _torch_state(run["states"][0])
    for i in range(2):
        state, _ = step(state, *map(torch.from_numpy, run["batches"][i]))
    states_dir = str(tmp_path / "training_states")
    assert tckpt.find_resume_state(states_dir) is None
    tckpt.save_training_state(state, states_dir, 1)
    path = tckpt.save_training_state(state, states_dir, 2)
    (tmp_path / "training_states" / "notes.txt").write_text("not a state")
    assert tckpt.find_resume_state(states_dir) == path and path.endswith("2.state")

    fresh = init_network(OPT, torch.Generator().manual_seed(1), device="cpu")
    other = tckpt.restore_training_state(path, ttrain.create_train_state(fresh, tcfg))
    assert other.step == 2
    batch = tuple(map(torch.from_numpy, run["batches"][2]))
    _, ma = step(state, *batch)
    _, mb = step(other, *batch)
    assert float(ma["total"]) == float(mb["total"])
    sa, sb = state.state_dict(), other.state_dict()
    assert sa["step"] == sb["step"] == 3 and sa["adam_step"] == sb["adam_step"] == 3
    for key in ("params", "exp_avg", "exp_avg_sq", "ema"):
        for n in sa[key]:
            assert torch.equal(sa[key][n], sb[key][n]), (key, n)
    no_ema = ttrain.create_train_state(fresh, dataclasses.replace(tcfg, ema_decay=0.0))
    with pytest.raises(ValueError, match="EMA"):
        tckpt.restore_training_state(path, no_ema)


def test_save_network_loads_through_the_jax_importer(tmp_path):
    """`save_network` writes the reference's `.pth` layout: the JAX package's
    importer and the port's `load_network` read it back to the same weights."""
    model = init_network(OPT, torch.Generator().manual_seed(2), device="cpu")
    path = tckpt.save_network(model, str(tmp_path / "models"), "net_g", 7)
    assert path.endswith("net_g_7.pth") and (tmp_path / "models" / "net_g_latest.pth").exists()
    assert tckpt.save_network(model, str(tmp_path / "models"), "net_g", -1).endswith(
        "net_g_latest.pth")
    back = convert.state_dict_from_jax(_np_tree(load_wavemamba_checkpoint(path)))
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    again = tckpt.load_network(path, device="cpu")
    assert all(torch.equal(again[k], v) for k, v in sd.items())


# --------------------------------------------------------------------- model: train

def test_remat_forward_and_gradients_equal_plain():
    """Block recompute changes memory, not numbers: the same bits."""
    lq, gt = map(torch.from_numpy, _batch(20))
    tcfg = ttrain.TrainConfig()
    results = []
    for remat in (False, True):
        model = init_network({**OPT, "remat": remat}, torch.Generator().manual_seed(3),
                             device="cpu")
        assert model.cfg.remat == remat
        total, _ = ttrain.loss_fn(model, tcfg, lq, gt)
        total.backward()
        results.append((float(total.detach()), [p.grad for p in model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)
    assert WaveMambaConfig().remat  # on by default, as in the JAX package


def test_matching_gradient_goes_through_the_gather_only():
    """`matching`'s argmin carries no gradient on either side (as in the JAX
    package); the gather sends the cotangent to the chosen channels of perc."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(1, 4, 3, 3).astype(np.float32)).requires_grad_()
    perc = torch.from_numpy(rs.rand(1, 4, 3, 3).astype(np.float32)).requires_grad_()
    twm.matching(x, perc).sum().backward()
    assert x.grad is None
    jg = jax.grad(lambda p: jnp.sum(jwm.matching(jnp.asarray(
        x.detach().permute(0, 2, 3, 1).numpy()), p)))(jnp.asarray(
            perc.detach().permute(0, 2, 3, 1).numpy()))
    np.testing.assert_array_equal(perc.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg))


def test_init_at_the_shipped_config():
    """`jax.random`'s numbers cannot be had: ranges, shapes and the count."""
    model = init_network({"type": "WaveMamba"}, torch.Generator().manual_seed(0), device="cpu")
    assert param_count(model) == 1_512_718 and model.training
    jparams = jwm.init_wavemamba(jax.random.PRNGKey(0), jwm.WaveMambaConfig())
    want = convert.state_dict_from_jax(_np_tree(jparams))
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in want.items()}
    # Deterministic parameters are the same numbers on both sides.
    for k, v in sd.items():
        if k.endswith(("A_logs", "Ds", "skip_scale", "skip_scale2", "temperature")) \
                or "norm" in k.lower() or k.endswith(("ln_1.weight", "ln_1.bias", "ln_2.weight",
                                                      "ln_2.bias", "conv_du.1.weight")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
    ss = model.restoration_network.down_group1.l_blk[0].self_attention.requires_grad_(False)
    d, r = 64, 2
    assert float(ss.x_proj_weight.abs().max()) <= 1 / np.sqrt(d)
    assert float(ss.x_proj_weight.abs().max()) > 0.9 / np.sqrt(d)
    assert float(ss.dt_projs_weight.abs().max()) <= r ** -0.5
    dt = torch.nn.functional.softplus(ss.dt_projs_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    conv = model.restoration_network.conv_01.requires_grad_(False)  # 3x3 over 3 channels: fan-in 27
    for t in (conv.weight, conv.bias):
        assert float(t.abs().max()) <= 1 / np.sqrt(27) and float(t.abs().max()) > 0.5 / np.sqrt(27)
    # Every random tensor has the spread of its JAX counterpart (U(+-b): std b/sqrt(3)).
    for k, v in sd.items():
        if v.numel() >= 512 and float(want[k].std()) > 0 and not k.endswith("A_logs"):
            assert abs(float(v.std()) / float(want[k].std()) - 1) < 0.15, k
    # The same seed gives the same model; another seed another.
    again = init_network({"type": "WaveMamba"}, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
