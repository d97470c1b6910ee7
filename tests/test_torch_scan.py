"""The port's scan (`wavemamba_torch/ops/scan.py`) and the K1 wrapper
(`ops/scan_cuda.py`) against wavemamba_tpu on the CPU.

`ss2d_scan_pair_plain`, the plain version of kernel K1, is held against the
TPU kernel itself, `ss2d_scan_fused` run in Pallas interpret mode, with the
JAX test's own tolerance (rtol = atol = 2e-5). The kernel has no CPU mode;
`chip_smoke.py` holds it against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch.ops import scan as tscan
from wavemamba_torch.ops import scan_cuda
from wavemamba_tpu.ops import scan as jscan
from wavemamba_tpu.ops.scan_pallas import ss2d_scan_fused

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


TOL = 2e-5


def _pair_inputs(seed, B, L, D, N, R):
    """The JAX test's inputs (`tests/test_scan_pallas.py:_fused_pair_inputs`)."""
    rs = np.random.RandomState(seed)
    return (
        (rs.rand(B, L, D) * 0.5).astype(np.float32),
        (rs.rand(2, D, R + 2 * N) * 0.2).astype(np.float32),
        (rs.rand(2, R, D) * 0.2).astype(np.float32),
        (rs.rand(2, D) * 0.1).astype(np.float32),
        -np.exp(rs.rand(2, N, D).astype(np.float32)),
        rs.rand(2, D).astype(np.float32),
    )


@pytest.mark.parametrize("B,L,D,N,R,chunk", [
    (2, 200, 16, 4, 2, 64),  # ragged tail: 200 = 3 * 64 + 8
    (1, 96, 64, 16, 2, 32),  # the shipped widths
])
def test_ss2d_scan_pair_plain_matches_fused_kernel(B, L, D, N, R, chunk):
    args = _pair_inputs(0, B, L, D, N, R)
    want = np.asarray(ss2d_scan_fused(*map(jnp.asarray, args), chunk=chunk, sub=8,
                                      interpret=True))
    got = tscan.ss2d_scan_pair_plain(*map(torch.from_numpy, args), chunk=chunk).numpy()
    assert got.shape == (B, 2, L, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # The wrapper sends a CPU tensor to the plain version at the kernel's
    # chunk, and counts no launch.
    before = scan_cuda.ss2d_scan_pair.launches
    wrapped = scan_cuda.ss2d_scan_pair(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(wrapped, tscan.ss2d_scan_pair_plain(
        *map(torch.from_numpy, args), chunk=scan_cuda.CHUNK).numpy())
    np.testing.assert_allclose(wrapped, want, rtol=TOL, atol=TOL)
    assert scan_cuda.ss2d_scan_pair.launches == before


BF16_STEP = 2.0 ** -7  # one bf16 step (8 significant bits), at most this share of the value


@pytest.mark.parametrize("x_bf16,y_bf16", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("B,L,D,N,R,chunk", [(2, 200, 16, 4, 2, 64), (1, 150, 64, 16, 2, 64)])
def test_ss2d_scan_pair_plain_matches_fused_kernel_on_bf16_streams(B, L, D, N, R, chunk,
                                                                    x_bf16, y_bf16):
    """K1's plain version on the bf16 presets' streams (bf16 x, y in bf16 or
    float32, and float32 x with bf16 y: `compute_dtype` and `scan_dtype` set
    apart) against the TPU kernel with `out_dtype`: both widen x and compute in
    float32, and round y once, so they differ by at most one bf16 step beyond
    TOL (measured: the same bits in bf16)."""
    args = _pair_inputs(0, B, L, D, N, R)
    x = torch.from_numpy(args[0])
    x = x.bfloat16() if x_bf16 else x
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x_bf16 else jnp.float32)
    want = ss2d_scan_fused(jx, *map(jnp.asarray, args[1:]), chunk=chunk, sub=8, interpret=True,
                           out_dtype=jnp.bfloat16 if y_bf16 else None)
    out_dtype = torch.bfloat16 if y_bf16 else None
    got = tscan.ss2d_scan_pair_plain(x, *map(torch.from_numpy, args[1:]), chunk=chunk,
                                     out_dtype=out_dtype)
    assert got.dtype == (torch.bfloat16 if y_bf16 else torch.float32) and got.shape == (B, 2, L, D)
    want = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got.float().numpy() - want) <= BF16_STEP * np.abs(want) + TOL).all()
    # The wrapper takes the same streams on a CPU tensor.
    wrapped = scan_cuda.ss2d_scan_pair(x, *map(torch.from_numpy, args[1:]), out_dtype=out_dtype)
    assert wrapped.dtype == got.dtype


def _scan_inputs(seed, B=2, K=4, L=45, D=8, N=4):
    rs = np.random.RandomState(seed)
    return (
        rs.randn(B, K, L, D).astype(np.float32),
        (rs.randn(B, K, L, D) * 0.5).astype(np.float32),
        -np.exp(rs.rand(K, D, N)).astype(np.float32),
        rs.randn(B, K, L, N).astype(np.float32),
        rs.randn(B, K, L, N).astype(np.float32),
        rs.randn(K, D).astype(np.float32),
        (rs.rand(K, D) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("impl,chunk", [("ref", None), ("chunked", 16), ("chunked", 64)])
def test_selective_scan_matches_jax_ref(impl, chunk):
    """The plain core (`selective_scan_ref` and the chunked form K1's plain
    version uses) against the JAX package's step-by-step reference."""
    args = _scan_inputs(1)
    want = np.asarray(jscan.selective_scan_ref(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(a) for a in args]
    if impl == "ref":
        got = tscan.selective_scan_ref(*targs)
    else:
        got = tscan.selective_scan_chunked(*targs, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


class FakeCuda:
    """A CPU tensor that claims the CUDA device type, so a CPU-only host
    reaches the wrapper's CUDA path (nothing there reads its data)."""

    def __init__(self, t):
        self.t = t
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("cuda", 0)
        self.requires_grad = False

    def is_contiguous(self):
        return self.t.is_contiguous()


def test_kernel_needs_a_card(monkeypatch):
    """Without CUDA the kernel's loader and the wrapper's non-CPU path raise;
    nothing falls back to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_cuda._library.__wrapped__()
    args = [torch.empty(s, device="meta") for s in
            [(1, 8, 16), (2, 16, 34), (2, 2, 16), (2, 16), (2, 16, 16), (2, 16)]]
    with pytest.raises(ValueError, match="unsupported device"):
        scan_cuda.ss2d_scan_pair(*args)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks run before any build or launch; a CPU-only host reaches
    them through a tensor that claims the CUDA device type."""
    x, wx, dtw, bias, A, dsk = (FakeCuda(torch.from_numpy(a))
                                for a in _pair_inputs(2, 1, 10, 16, 4, 2))
    with pytest.raises(ValueError, match="N=16"):  # the kernel is built for N = 16
        scan_cuda.ss2d_scan_pair(x, wx, dtw, bias, A, dsk)
    x64 = FakeCuda(x.t.double())
    with pytest.raises(ValueError, match="float32"):
        scan_cuda.ss2d_scan_pair(x64, wx, dtw, bias, A, dsk)


@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, None), (torch.float32, torch.bfloat16)])
def test_kernel_wrapper_refuses_mixed_stream_dtypes(monkeypatch, x_dtype, out_dtype):
    """K1 is built for three (x, y) pairs: both float32, both bf16, and bf16 x
    with float32 y (out_dtype None), which the proc ymls train with. That mix
    passes every check and reaches the kernel's loader, which raises on a host
    without CUDA; float32 x with bf16 y is refused by name before any build.
    Neither counts a launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [FakeCuda(torch.from_numpy(a)) for a in _pair_inputs(3, 1, 70, 64, 16, 2)]
    args[0] = FakeCuda(args[0].t.to(x_dtype))
    before = scan_cuda.ss2d_scan_pair.launches
    if x_dtype == torch.float32:
        with pytest.raises(NotImplementedError, match="float32 x with bfloat16 y"):
            scan_cuda.ss2d_scan_pair(*args, out_dtype=out_dtype)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            scan_cuda.ss2d_scan_pair(*args, out_dtype=out_dtype)
    assert scan_cuda.ss2d_scan_pair.launches == before


def test_kernel_wrapper_raises_without_a_card(monkeypatch):
    """Inputs the kernel takes (N=16, R=2, D=64) on the CUDA device type pass
    every check and reach the kernel's loader, which raises on a host without
    CUDA: the wrapper neither falls back to the plain version nor counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [FakeCuda(torch.from_numpy(a)) for a in _pair_inputs(3, 1, 70, 64, 16, 2)]
    before = scan_cuda.ss2d_scan_pair.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_cuda.ss2d_scan_pair(*args)
    assert scan_cuda.ss2d_scan_pair.launches == before
