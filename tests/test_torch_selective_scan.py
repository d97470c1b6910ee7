"""The port's unfused selective scan (`wavemamba_torch/ops/scan.py`) and the
K3 / K4 wrappers (`ops/scan_cuda.py`) against wavemamba_tpu on the CPU.

`selective_scan_plain` and `selective_scan_plain_bwd`, the plain versions of
kernels K3 and K4, are held against the TPU kernels themselves
(`selective_scan_pallas`, `selective_scan_pallas_bwd`, in Pallas interpret
mode) and against the step-by-step reference. Forward tolerance: the JAX
test's own, rtol = atol = 2e-5 (`tests/test_scan_pallas.py`). Backward: the
max difference over the output's max; the JAX test allows 2e-4, measured here
at most 2e-6, held to 1e-5. Carries are an internal layout of each package
and are not compared. The kernels have no CPU mode; `chip_smoke.py` holds
them against the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scan import FakeCuda

from wavemamba_torch.ops import scan as tscan
from wavemamba_torch.ops import scan_cuda
from wavemamba_tpu.ops import scan as jscan
from wavemamba_tpu.ops.scan_pallas import selective_scan_pallas, selective_scan_pallas_bwd

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

TOL = 2e-5
REL = 1e-5
NAMES = ("du", "ddelta", "dA", "dBs", "dCs", "dD_skip", "ddelta_bias")
CASES = [
    (2, 4, 45, 8, 4, 16),  # ragged: 45 = 2 * 16 + 13
    (1, 2, 128, 8, 4, 32),  # whole chunks
    (1, 4, 100, 64, 16, 64),  # the shipped widths, ragged
]


def _inputs(seed, B, K, L, D, N, dtype=np.float32):
    rs = np.random.RandomState(seed)
    args = (rs.randn(B, K, L, D), rs.randn(B, K, L, D) * 0.5, -np.exp(rs.rand(K, D, N)),
            rs.randn(B, K, L, N), rs.randn(B, K, L, N), rs.randn(K, D), rs.rand(K, D) * 0.1)
    return tuple(a.astype(dtype) for a in args), rs.randn(B, K, L, D).astype(dtype)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("B,K,L,D,N,chunk", CASES)
def test_plain_matches_pallas_kernel_and_ref(B, K, L, D, N, chunk):
    args, _ = _inputs(1, B, K, L, D, N)
    jargs = tuple(map(jnp.asarray, args))
    want = np.asarray(selective_scan_pallas(*jargs, chunk=chunk, sub=8, interpret=True))
    ref = np.asarray(jscan.selective_scan_ref(*jargs))
    targs = tuple(map(torch.from_numpy, args))
    got, state, sumda = tscan.selective_scan_plain(*targs, chunk=chunk, return_carries=True)
    nc = -(-L // chunk)
    assert got.shape == (B, K, L, D) and got.dtype == torch.float32
    assert state.shape == (B, K, nc, N, D) and sumda.shape == (B, K, nc, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.numpy(), tscan.selective_scan_plain(*targs, chunk=chunk).numpy())
    # The first chunk is entered with h = 0 and a chunk's decay is exp(A * sumda).
    assert float(state[:, :, 0].abs().max()) == 0.0
    da = np.log1p(np.exp(args[1] + args[6][None, :, None, :]))
    np.testing.assert_allclose(sumda[:, :, 0].numpy(), da[:, :, :chunk].sum(2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,K,L,D,N,chunk", CASES)
def test_plain_bwd_matches_pallas_bwd_kernel(B, K, L, D, N, chunk):
    args, dy = _inputs(3, B, K, L, D, N)
    jargs = tuple(map(jnp.asarray, args))
    _, carries = selective_scan_pallas(*jargs, chunk=chunk, sub=8, interpret=True,
                                       return_carries=True)
    want = selective_scan_pallas_bwd(*jargs, carries, jnp.asarray(dy), chunk=chunk, sub=8,
                                     interpret=True)
    targs = tuple(map(torch.from_numpy, args))
    _, state, _ = tscan.selective_scan_plain(*targs, chunk=chunk, return_carries=True)
    got = tscan.selective_scan_plain_bwd(*targs, state, torch.from_numpy(dy), chunk=chunk)
    assert len(got) == len(want) == 7
    for g, w, a, name in zip(got, want, args, NAMES):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        assert _rel(g.numpy(), np.asarray(w)) < REL, (name, _rel(g.numpy(), np.asarray(w)))


@pytest.mark.parametrize("B,K,L,D,N,chunk", CASES[:2])
def test_plain_bwd_matches_autograd_of_ref(B, K, L, D, N, chunk):
    args, dy = _inputs(5, B, K, L, D, N)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    want = torch.autograd.grad((tscan.selective_scan_ref(*targs) * torch.from_numpy(dy)).sum(), targs)
    jwant = jax.grad(lambda *a: jnp.sum(jscan.selective_scan_ref(*a) * jnp.asarray(dy)),
                     argnums=tuple(range(7)))(*map(jnp.asarray, args))
    with torch.no_grad():
        _, state, _ = tscan.selective_scan_plain(*targs, chunk=chunk, return_carries=True)
        got = tscan.selective_scan_plain_bwd(*targs, state, torch.from_numpy(dy), chunk=chunk)
    for g, w, jw, name in zip(got, want, jwant, NAMES):
        assert _rel(g.numpy(), w.numpy()) < REL, (name, _rel(g.numpy(), w.numpy()))
        assert _rel(g.numpy(), np.asarray(jw)) < REL, (name, _rel(g.numpy(), np.asarray(jw)))


def test_function_gradcheck_float64():
    """`SelectiveScan` (plain forward with carries, plain backward on the CPU)
    in float64 on a tiny case with a ragged tail (70 = 64 + 6)."""
    args, _ = _inputs(7, 1, 2, 70, 3, 2, dtype=np.float64)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    assert torch.autograd.gradcheck(scan_cuda.SelectiveScan.apply, targs, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("L,sub", [(45, 16), (64, 8), (37, 32)])
def test_par_matches_jax(L, sub):
    args, _ = _inputs(9, 2, 4, L, 8, 4)
    want = np.asarray(jscan.selective_scan_par(*map(jnp.asarray, args), sub=sub))
    got = tscan.selective_scan_par(*map(torch.from_numpy, args), sub=sub)
    assert got.shape == (2, 4, L, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L,chunk", [(45, 16), (64, 32)])
def test_chunked_h0_and_final_state_match_jax(L, chunk):
    """A scan cut in two: the second half entered with the first half's exit
    state equals the whole, and both equal the JAX function's."""
    args, _ = _inputs(11, 2, 4, L, 8, 4)
    rs = np.random.RandomState(12)
    h0 = rs.randn(2, 4, 8, 4).astype(np.float32)
    jy, jh = jscan.selective_scan_chunked(*map(jnp.asarray, args), chunk=chunk,
                                          h0=jnp.asarray(h0), return_final=True)
    targs = tuple(map(torch.from_numpy, args))
    y, h = tscan.selective_scan_chunked(*targs, chunk=chunk, h0=torch.from_numpy(h0),
                                        return_final=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)
    cut = L // 2 + 1
    halves = [tuple(t[:, :, s] if t.dim() == 4 else t for t in targs)
              for s in (slice(0, cut), slice(cut, None))]
    y1, h1 = tscan.selective_scan_chunked(*halves[0], chunk=chunk, h0=torch.from_numpy(h0),
                                          return_final=True)
    y2, h2 = tscan.selective_scan_chunked(*halves[1], chunk=chunk, h0=h1, return_final=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 2).numpy(), y.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["ref", "chunked", "par", "pallas"])
def test_dispatcher_matches_jax_forward_and_gradient(impl):
    """Every route of `selective_scan` against the JAX dispatcher's same route
    ('pallas' there runs the kernels in interpret mode off the TPU)."""
    args, dy = _inputs(13, 1, 4, 70, 8, 4)
    jargs = tuple(map(jnp.asarray, args))
    kw = dict(impl=impl, chunk=32, sub=8)
    want = np.asarray(jscan.selective_scan(*jargs, **kw))
    jgrads = jax.grad(lambda *a: jnp.sum(jscan.selective_scan(*a, **kw) * jnp.asarray(dy)),
                      argnums=tuple(range(7)))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tscan.selective_scan(*targs, **kw)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=TOL, atol=TOL)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), targs)
    for g, w, name in zip(grads, jgrads, NAMES):
        assert _rel(g.numpy(), np.asarray(w)) < REL, (impl, name, _rel(g.numpy(), np.asarray(w)))


def test_dispatcher_rejects_unknown_routes_and_bf16():
    targs = tuple(map(torch.from_numpy, _inputs(14, 1, 2, 8, 4, 4)[0]))
    with pytest.raises(ValueError, match="unknown selective_scan impl"):
        tscan.selective_scan(*targs, impl="fast")
    with pytest.raises(NotImplementedError, match="item 4"):
        tscan.selective_scan(*targs, impl="chunked", scan_dtype=torch.bfloat16)


def test_wrapper_is_differentiable_and_counts_nothing_on_the_cpu():
    """`selective_scan_cuda` sends CPU tensors to the plain version at the
    kernel's chunk, goes through `SelectiveScan` when an input requires grad
    and gives the gradients of the plain backward; no launch is counted."""
    args, dy = _inputs(15, 2, 4, 90, 16, 4)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    before = scan_cuda.selective_scan_cuda.launches, scan_cuda.selective_scan_cuda_bwd.launches
    y = scan_cuda.selective_scan_cuda(*targs)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), targs)
    with torch.no_grad():
        y2, state, sumda = scan_cuda.selective_scan_cuda(*targs, return_carries=True)
        want = scan_cuda.selective_scan_cuda_bwd(*targs, state, sumda, torch.from_numpy(dy))
        plain = tscan.selective_scan_plain(*targs, chunk=scan_cuda.CHUNK)
    np.testing.assert_array_equal(y.detach().numpy(), y2.numpy())
    np.testing.assert_array_equal(y2.numpy(), plain.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (scan_cuda.selective_scan_cuda.launches,
            scan_cuda.selective_scan_cuda_bwd.launches) == before


def _fake_args(seed, B, K, L, D, N, bwd):
    args, dy = _inputs(seed, B, K, L, D, N)
    if bwd:
        nc = -(-L // scan_cuda.CHUNK)
        args += (np.zeros((B, K, nc, N, D), np.float32), np.zeros((B, K, nc, D), np.float32), dy)
    return [FakeCuda(torch.from_numpy(a)) for a in args]


@pytest.mark.parametrize("bwd", [False, True], ids=["K3", "K4"])
def test_kernel_wrappers_raise_without_a_card(monkeypatch, bwd):
    """Inputs the kernels take (N=16, D=64) on the CUDA device type pass every
    check and reach the kernel's loader, which raises on a host without CUDA:
    the wrapper neither falls back to the plain version nor counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = scan_cuda.selective_scan_cuda_bwd if bwd else scan_cuda.selective_scan_cuda
    loader = scan_cuda._library_k4 if bwd else scan_cuda._library_k3
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.__wrapped__()
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*_fake_args(16, 1, 4, 70, 64, 16, bwd))
    assert fn.launches == before
    meta = [torch.empty(t.shape, device="meta") for t in _fake_args(16, 1, 4, 70, 64, 16, bwd)]
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*meta)


@pytest.mark.parametrize("bwd,D,N,match", [(False, 16, 4, "N=16"), (False, 512, 16, "D<=256"),
                                           (True, 16, 4, "N=16"), (True, 256, 16, "D<=128")])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(bwd, D, N, match):
    """The checks run before any build or launch: nothing is truncated."""
    fn = scan_cuda.selective_scan_cuda_bwd if bwd else scan_cuda.selective_scan_cuda
    with pytest.raises(ValueError, match=match):
        fn(*_fake_args(17, 1, 2, 10, D, N, bwd))
    fake = _fake_args(17, 1, 2, 10, 64, 16, bwd)
    fake[3] = FakeCuda(fake[3].t[:, :, :, :8])  # Bs of another width
    with pytest.raises(ValueError, match="Bs must be float32"):
        fn(*fake)
    fake = _fake_args(17, 1, 2, 10, 64, 16, bwd)
    fake[0] = FakeCuda(fake[0].t.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="u must be contiguous"):
        fn(*fake)
