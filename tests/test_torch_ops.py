"""wavemamba_torch primitives and Haar transform against wavemamba_tpu on
the CPU. The port is NCHW inside, the JAX package NHWC: inputs are made with
numpy and transposed at the boundary. Tolerance: atol 1e-6 (both sides f32); the activations, whose erf/exp come
from different libraries, also allow two f32 ulps of their value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from wavemamba_torch.ops import haar as thaar
from wavemamba_torch.ops import nn as tnn
from wavemamba_tpu.ops import haar as jhaar
from wavemamba_tpu.ops import nn as jnn

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

ATOL = 1e-6
ULP2 = 2.0**-22  # two float32 ulps, relative


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("k,cin,cout,groups", [(1, 8, 12, 1), (3, 8, 8, 8), (3, 6, 4, 1), (3, 12, 12, 12)])
def test_conv2d_matches(k, cin, cout, groups):
    x = _rand(0, 2, 10, 14, cin)
    conv = nn.Conv2d(cin, cout, k, padding=k // 2, groups=groups)
    w = conv.weight.detach().numpy()  # OIHW
    b = conv.bias.detach().numpy()
    p = {"w": jnp.asarray(np.transpose(w, (2, 3, 1, 0))), "b": jnp.asarray(b)}
    want = np.asarray(jnn.conv2d(p, jnp.asarray(x), padding=k // 2, groups=groups))
    with torch.no_grad():
        got = _nhwc(conv(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_linear_matches():
    x = _rand(1, 3, 5, 16)
    lin = nn.Linear(16, 24)
    p = {"w": jnp.asarray(lin.weight.detach().numpy().T), "b": jnp.asarray(lin.bias.detach().numpy())}
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnn.linear(p, jnp.asarray(x))), atol=ATOL, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dim", [1, -1])
def test_layer_norm_matches(eps, dim):
    x = _rand(2, 2, 6, 7, 12, scale=3.0) + 0.5
    g, b = _rand(3, 12), _rand(4, 12)
    want = np.asarray(jnn.layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x), eps=eps))
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    if dim == 1:  # channel LN on NCHW
        got = _nhwc(tnn.layer_norm(_nchw(x), gt, bt, eps=eps, dim=1))
    else:
        got = tnn.layer_norm(torch.from_numpy(x), gt, bt, eps=eps, dim=-1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activations_match(name):
    x = _rand(5, 4, 33, scale=3.0)
    want = np.asarray(getattr(jnn, name)(jnp.asarray(x)))
    got = getattr(F, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ULP2)


def test_prelu_matches():
    x = _rand(6, 2, 5, 5, 4)
    want = np.asarray(jnn.prelu({"a": jnp.asarray([0.3], jnp.float32)}, jnp.asarray(x)))
    m = nn.PReLU()
    with torch.no_grad():
        m.weight.fill_(0.3)
        got = _nhwc(m(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_l2_normalize_matches():
    x = _rand(7, 2, 40, 1, 8)
    x[0, :, 0, 3] = 0.0  # an all-zero vector takes the eps floor
    want = np.asarray(jnn.l2_normalize(jnp.asarray(x), axis=1))
    got = tnn.l2_normalize(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_pixel_unshuffle_and_shuffle_match(r):
    x = _rand(8, 2, 16, 24, 3)
    down = np.asarray(jnn.pixel_unshuffle(jnp.asarray(x), r))
    got = _nhwc(nn.PixelUnshuffle(r)(_nchw(x)))
    np.testing.assert_array_equal(got, down)
    up = np.asarray(jnn.pixel_shuffle(jnp.asarray(down), r))
    np.testing.assert_array_equal(_nhwc(F.pixel_shuffle(_nchw(down), r)), up)


def test_dwt2_iwt2_match():
    x = _rand(9, 2, 12, 18, 5)
    want = jhaar.dwt2(jnp.asarray(x))
    got = thaar.dwt2(_nchw(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL, rtol=0)
    back = thaar.iwt2(*got)
    np.testing.assert_allclose(_nhwc(back), np.asarray(jhaar.iwt2(*want)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_nhwc(back), x, atol=ATOL, rtol=0)


def test_iwt2_cat_matches():
    x = _rand(10, 1, 6, 10, 16)
    want = np.asarray(jhaar.iwt2_cat(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(thaar.iwt2_cat(_nchw(x))), want, atol=ATOL, rtol=0)
