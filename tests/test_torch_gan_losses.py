"""The port's GAN losses (`wavemamba_torch/losses/losses.py`, the registry's
`GANLoss`, `MultiScaleGANLoss`, `GANFeatLoss`) against `wavemamba_tpu` on
the CPU, rtol 1e-6 (the R1 penalty's own gradient, a second derivative,
rtol 1e-5 and atol 1e-6).

The penalties differentiate a small conv discriminator (or generator) with
the same weights on both sides: JAX through `jax.grad`, the port through
`torch.autograd.grad(..., create_graph=True)`, which must also give the
penalty a gradient of its own. Where JAX draws from a key, the test draws
once from a seeded `torch.Generator` and hands JAX the same numbers by
patching `jax.random.uniform` / `normal` for the call.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavemamba_torch.losses import build_loss
from wavemamba_torch.losses import losses as tl
from wavemamba_tpu.losses import build_loss as jbuild_loss
from wavemamba_tpu.losses import losses as jl

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

RTOL = 1e-6
GAN_TYPES = ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"]


def _arr(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("is_disc", [False, True], ids=["gen", "disc"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "fake"])
@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_gan_loss_matches(gan_type, real, is_disc):
    pred = _arr(0, 2, 5, 5, 1, scale=2.0)
    kw = dict(gan_type=gan_type, real_label_val=0.9, fake_label_val=0.1, loss_weight=0.5,
              is_disc=is_disc)
    want = float(jl.gan_loss(jnp.asarray(pred), real, **kw))
    got = float(tl.gan_loss(torch.from_numpy(pred), real, **kw))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_gan_loss_unknown_type():
    with pytest.raises(NotImplementedError, match="GAN type"):
        tl.gan_loss(torch.zeros(2), True, gan_type="nope")


@pytest.mark.parametrize("gan_type", ["vanilla", "hinge"])
def test_multi_scale_and_registry_match(gan_type):
    """Nested predictions take their last tensor; the registry's partials."""
    preds = [[_arr(1, 2, 4, 4, 1), _arr(2, 2, 4, 4, 1)], _arr(3, 2, 2, 2, 1)]
    kw = {"gan_type": gan_type, "loss_weight": 0.7}
    want = float(jl.multi_scale_gan_loss(
        [[jnp.asarray(p) for p in q] if isinstance(q, list) else jnp.asarray(q) for q in preds],
        False, **kw))
    tpreds = [[torch.from_numpy(p) for p in q] if isinstance(q, list) else torch.from_numpy(q)
              for q in preds]
    np.testing.assert_allclose(float(tl.multi_scale_gan_loss(tpreds, False, **kw)), want, rtol=RTOL)
    for name in ("GANLoss", "MultiScaleGANLoss"):
        opt = {"type": name, **kw}
        p = tpreds if name == "MultiScaleGANLoss" else tpreds[1]
        jp = [[jnp.asarray(x) for x in q] if isinstance(q, list) else jnp.asarray(q)
              for q in preds] if name == "MultiScaleGANLoss" else jnp.asarray(preds[1])
        np.testing.assert_allclose(float(build_loss(opt)(p, True)),
                                   float(jbuild_loss(opt)(jp, True)), rtol=RTOL)


@pytest.mark.parametrize("criterion", ["l1", "l2", "charbonnier"])
def test_gan_feat_loss_matches(criterion):
    """Two discriminators of three features each (the last, the logits, is left out)."""
    fake = [[_arr(10 + 3 * d + i, 2, 6, 6, 4) for i in range(3)] for d in range(2)]
    real = [[_arr(40 + 3 * d + i, 2, 6, 6, 4) for i in range(3)] for d in range(2)]
    to_j = lambda fs: [[jnp.asarray(f) for f in d] for d in fs]  # noqa: E731
    to_t = lambda fs: [[torch.from_numpy(f) for f in d] for d in fs]  # noqa: E731
    want = float(jl.gan_feat_loss(to_j(fake), to_j(real), criterion, loss_weight=2.0))
    got = float(tl.gan_feat_loss(to_t(fake), to_t(real), criterion, loss_weight=2.0))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    reg = build_loss({"type": "GANFeatLoss", "criterion": criterion, "loss_weight": 2.0})
    np.testing.assert_allclose(float(reg(to_t(fake), to_t(real))), want, rtol=RTOL)


# A small conv discriminator with one set of weights for both sides (NHWC in).
W1, B1 = _arr(60, 3, 3, 3, 8, scale=0.3), _arr(61, 8, scale=0.1)
W2, B2 = _arr(62, 3, 3, 8, 1, scale=0.3), _arr(63, 1, scale=0.1)


def _disc_jax(x):
    dn = ("NHWC", "HWIO", "NHWC")
    h = jax.lax.conv_general_dilated(x, jnp.asarray(W1), (1, 1), "SAME", dimension_numbers=dn)
    h = jax.nn.leaky_relu(h + B1, 0.2)
    h = jax.lax.conv_general_dilated(h, jnp.asarray(W2), (2, 2), [(1, 1), (1, 1)],
                                     dimension_numbers=dn)
    return h + B2


def _disc_torch(params=None):
    w1, b1, w2, b2 = params or [torch.from_numpy(a) for a in (W1, B1, W2, B2)]

    def d(x):
        h = F.conv2d(x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1), b1, padding=1)
        h = F.leaky_relu(h, 0.2)
        h = F.conv2d(h, w2.permute(3, 2, 0, 1), b2, stride=2, padding=1)
        return h.permute(0, 2, 3, 1)

    return d


def test_r1_penalty_matches_and_trains():
    real = _arr(70, 2, 8, 8, 3)
    want = float(jl.r1_penalty(_disc_jax, jnp.asarray(real)))
    params = [torch.from_numpy(a).requires_grad_(True) for a in (W1, B1, W2, B2)]
    pen = tl.r1_penalty(_disc_torch(params), torch.from_numpy(real))
    np.testing.assert_allclose(float(pen.detach()), want, rtol=RTOL)
    grads = torch.autograd.grad(pen, params[:3])  # the penalty trains the discriminator (not b2)
    jgrad = jax.grad(lambda w1: jl.r1_penalty(
        lambda x: _disc_jax_w1(x, w1), jnp.asarray(real)))(jnp.asarray(W1))
    # a second derivative: its sums run in another order than JAX's
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)


def _disc_jax_w1(x, w1):
    dn = ("NHWC", "HWIO", "NHWC")
    h = jax.lax.conv_general_dilated(x, w1, (1, 1), "SAME", dimension_numbers=dn)
    h = jax.nn.leaky_relu(h + B1, 0.2)
    h = jax.lax.conv_general_dilated(h, jnp.asarray(W2), (2, 2), [(1, 1), (1, 1)],
                                     dimension_numbers=dn)
    return h + B2


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_gradient_penalty_matches(weighted, monkeypatch):
    real, fake = _arr(71, 3, 8, 8, 3), _arr(72, 3, 8, 8, 3)
    weight = np.abs(_arr(73, 3, 8, 8, 1)) if weighted else None
    alpha = torch.rand((3, 1, 1, 1), generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(alpha.numpy()))
    want = float(jl.gradient_penalty_loss(_disc_jax, jnp.asarray(real), jnp.asarray(fake),
                                          jax.random.PRNGKey(0),
                                          None if weight is None else jnp.asarray(weight)))
    got = tl.gradient_penalty_loss(_disc_torch(), torch.from_numpy(real), torch.from_numpy(fake),
                                   torch.Generator().manual_seed(4),
                                   None if weight is None else torch.from_numpy(weight))
    np.testing.assert_allclose(float(got.detach()), want, rtol=RTOL)


def test_path_regularize_matches(monkeypatch):
    """A linear 'generator' from (B, 2, 6) latents to 4x4 RGB images."""
    wg = _arr(80, 12, 48, scale=0.2)
    latents = _arr(81, 2, 2, 6)
    def gen_j(z):
        return jnp.tanh(z.reshape(2, 12) @ jnp.asarray(wg)).reshape(2, 4, 4, 3)

    def gen_t(z):
        return torch.tanh(z.reshape(2, 12) @ torch.from_numpy(wg)).reshape(2, 4, 4, 3)

    noise = torch.randn((2, 4, 4, 3), generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(noise.numpy()))
    pen_j, lengths_j, mean_j = jl.g_path_regularize(gen_j, jnp.asarray(latents), 0.3,
                                                   jax.random.PRNGKey(0))
    pen, lengths, mean = tl.g_path_regularize(gen_t, torch.from_numpy(latents), 0.3,
                                              torch.Generator().manual_seed(5))
    np.testing.assert_allclose(float(pen), float(pen_j), rtol=RTOL)
    np.testing.assert_allclose(lengths.detach().numpy(), np.asarray(lengths_j), rtol=RTOL)
    np.testing.assert_allclose(float(mean), float(mean_j), rtol=RTOL)
    assert math.isfinite(float(pen)) and pen.requires_grad
