"""K2's plain version (`wavemamba_torch/ops/scan.py:ss2d_scan_pair_plain_bwd`),
its wrapper and the autograd Function (`ops/scan_cuda.py`) against
wavemamba_tpu on the CPU.

The plain backward is held against the TPU kernel itself,
`ss2d_scan_fused_bwd` run in Pallas interpret mode on the carries of
`ss2d_scan_fused(return_carries=True)`, and against `torch.autograd` through
the plain forward. The JAX test allows a max error of 2e-4 of the output's
max (`tests/test_scan_pallas.py`); measured here at most 8e-7, held to 5e-6.
The kernel has no CPU mode; `chip_smoke.py` holds it against the plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scan import FakeCuda

from wavemamba_torch.ops import scan as tscan
from wavemamba_torch.ops import scan_cuda
from wavemamba_tpu.ops.scan_pallas import ss2d_scan_fused, ss2d_scan_fused_bwd

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

REL = 5e-6
NAMES = ("dx", "dwx", "ddtw", "dbias", "dA", "ddsk")
CASES = [
    (2, 200, 16, 4, 2, 64),  # the JAX test's inputs, ragged tail: 200 = 3 * 64 + 8
    (1, 150, 64, 16, 2, 64),  # the shipped widths
]


def _pair_inputs(seed, B, L, D, N, R, dtype=np.float32):
    """The JAX test's inputs (`tests/test_scan_pallas.py:_fused_pair_inputs`)
    and a cotangent."""
    rs = np.random.RandomState(seed)
    args = (rs.rand(B, L, D) * 0.5, rs.rand(2, D, R + 2 * N) * 0.2, rs.rand(2, R, D) * 0.2,
            rs.rand(2, D) * 0.1, -np.exp(rs.rand(2, N, D)), rs.rand(2, D))
    return tuple(a.astype(dtype) for a in args), rs.randn(B, 2, L, D).astype(dtype)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("B,L,D,N,R,chunk", CASES)
def test_plain_bwd_matches_fused_bwd_kernel(B, L, D, N, R, chunk):
    args, dy = _pair_inputs(3, B, L, D, N, R)
    jargs = tuple(map(jnp.asarray, args))
    _, carries = ss2d_scan_fused(*jargs, chunk=chunk, sub=8, interpret=True,
                                 return_carries=True)
    want = ss2d_scan_fused_bwd(*jargs, carries, jnp.asarray(dy), chunk=chunk, sub=8,
                               interpret=True)
    targs = tuple(map(torch.from_numpy, args))
    y, state, sumda = tscan.ss2d_scan_pair_plain(*targs, chunk=chunk, return_carries=True)
    nc = -(-L // chunk)
    assert state.shape == (B, 2, nc, N, D) and sumda.shape == (B, 2, nc, D)
    # The JAX kernel keeps its carries in processing order; the port indexes
    # them by the chunk's place in the stream, so member 1 is flipped.
    jc = np.asarray(carries)
    jc = np.stack([jc[:, 0], jc[:, 1, ::-1]], 1)
    np.testing.assert_allclose(state.numpy(), jc, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(y.numpy(), tscan.ss2d_scan_pair_plain(*targs, chunk=chunk).numpy())
    # Fed with the JAX kernel's own carries, as the kernel's backward is.
    got = tscan.ss2d_scan_pair_plain_bwd(*targs, torch.from_numpy(jc.copy()),
                                         torch.from_numpy(dy), chunk=chunk)
    for g, w, a, name in zip(got, want, (args[0],) + args[1:], NAMES):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        assert _rel(g.numpy(), np.asarray(w)) < REL, (name, _rel(g.numpy(), np.asarray(w)))


@pytest.mark.parametrize("B,L,D,N,R,chunk", CASES)
def test_plain_bwd_matches_autograd_of_plain_forward(B, L, D, N, R, chunk):
    args, dy = _pair_inputs(5, B, L, D, N, R)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tscan.ss2d_scan_pair_plain(*targs, chunk=chunk)
    want = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), targs)
    with torch.no_grad():
        _, state, _ = tscan.ss2d_scan_pair_plain(*targs, chunk=chunk, return_carries=True)
        got = tscan.ss2d_scan_pair_plain_bwd(*targs, state, torch.from_numpy(dy), chunk=chunk)
    for g, w, name in zip(got, want, NAMES):
        assert _rel(g.numpy(), w.numpy()) < REL, (name, _rel(g.numpy(), w.numpy()))


def test_function_gradcheck_float64():
    """The Function (plain forward with carries, plain backward on the CPU) in
    float64 on a tiny case with a ragged tail (70 = 64 + 6)."""
    args, _ = _pair_inputs(7, 1, 70, 3, 2, 1, dtype=np.float64)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    assert torch.autograd.gradcheck(scan_cuda.SS2DScanPair.apply, targs, eps=1e-6, atol=1e-6)


def test_wrapper_is_differentiable_and_counts_nothing_on_the_cpu():
    """`ss2d_scan_pair` goes through the Function when an input requires grad
    and gives the gradients of the plain backward; no launch is counted."""
    args, dy = _pair_inputs(8, 2, 90, 16, 4, 2)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    before = scan_cuda.ss2d_scan_pair.launches, scan_cuda.ss2d_scan_pair_bwd.launches
    y = scan_cuda.ss2d_scan_pair(*targs)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), targs)
    with torch.no_grad():
        y2, state, sumda = scan_cuda.ss2d_scan_pair(*targs, return_carries=True)
        want = scan_cuda.ss2d_scan_pair_bwd(*targs, state, sumda, torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), y2.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (scan_cuda.ss2d_scan_pair.launches, scan_cuda.ss2d_scan_pair_bwd.launches) == before


def _fake_bwd_args(seed, B, L, D, N, R):
    args, dy = _pair_inputs(seed, B, L, D, N, R)
    nc = -(-L // scan_cuda.CHUNK)
    extra = (np.zeros((B, 2, nc, N, D), np.float32), np.zeros((B, 2, nc, D), np.float32), dy)
    return [FakeCuda(torch.from_numpy(a)) for a in args + extra]


def test_bwd_wrapper_raises_without_a_card(monkeypatch):
    """Inputs K2 takes (N=16, R=2, D=64) on the CUDA device type pass every
    check and reach the kernel's loader, which raises on a host without CUDA:
    the wrapper neither falls back to the plain version nor counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_cuda._library_bwd.__wrapped__()
    before = scan_cuda.ss2d_scan_pair_bwd.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_cuda.ss2d_scan_pair_bwd(*_fake_bwd_args(9, 1, 70, 64, 16, 2))
    assert scan_cuda.ss2d_scan_pair_bwd.launches == before


@pytest.mark.parametrize("D,N,match", [(16, 4, "N=16"), (128, 16, "D<=64")])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(D, N, match):
    with pytest.raises(ValueError, match=match):
        scan_cuda.ss2d_scan_pair_bwd(*_fake_bwd_args(10, 1, 10, D, N, 2))
    fake = _fake_bwd_args(10, 1, 10, 64, 16, 2)
    fake[-1] = FakeCuda(fake[-1].t[:, :, :5])  # dy of another length
    with pytest.raises(ValueError, match="dy must be float32"):
        scan_cuda.ss2d_scan_pair_bwd(*fake)
