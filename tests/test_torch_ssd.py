"""K5's plain version (`ss2d_scan_pair_plain(..., variant='ssd')`) and its
wrapper (`ops/scan_cuda.py:ss2d_scan_pair_ssd`) against wavemamba_tpu on the
CPU.

The TPU kernel `ss2d_scan_fused(..., variant='ssd')` runs in Pallas interpret
mode; the JAX test's tolerance holds (rtol = atol = 2e-5,
`tests/test_scan_pallas.py`), though the two cut the reverse member's segments
differently: the TPU pads L at the end, so that member's first segment starts
on pad tokens, while the port's segments start at the stream's true tail, as
its kernel's do. That changes rounding only. Against K1's plain version (the
same recurrence step by step): 1e-5. The kernel itself has no CPU mode;
`chip_smoke.py` holds it against this plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch.ops import scan as tscan
from wavemamba_torch.ops import scan_cuda
from wavemamba_tpu.ops.scan_pallas import ss2d_scan_fused

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

TOL, K1_TOL = 2e-5, 1e-5


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


def _jax_carries(cr, nc):
    """The TPU kernel's carries (B, 2, nc, N, D), each member in its own
    processing order -> the port's layout, indexed by the chunk's place in the
    stream (member 1 processes chunk c at step nc-1-c)."""
    return np.stack([cr[:, 0], cr[:, 1, ::-1]], 1)


@pytest.mark.parametrize("B,L,D,N,R", [
    (2, 200, 16, 4, 2),   # ragged: 200 = 3 * 64 + 8; the reverse member starts on the tail
    (1, 192, 16, 4, 2),   # whole chunks
    (1, 100, 64, 16, 2),  # the shipped widths, ragged
])
def test_ssd_plain_matches_tpu_kernel(B, L, D, N, R):
    args = _pair_inputs(7, B, L, D, N, R)
    y_want, cr = ss2d_scan_fused(*map(jnp.asarray, args), chunk=64, sub=8, interpret=True,
                                 return_carries=True, variant="ssd")
    y, state, sumda = tscan.ss2d_scan_pair_plain(*map(torch.from_numpy, args), chunk=64,
                                                 return_carries=True, variant="ssd", sub=8)
    nc = -(-L // 64)
    assert y.shape == (B, 2, L, D) and state.shape == (B, 2, nc, N, D) and sumda.shape == (B, 2, nc, D)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(state.numpy(), _jax_carries(np.asarray(cr), nc), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L,sub", [(200, 8), (37, 8), (256, 16), (130, 4)])
def test_ssd_plain_matches_twopass_plain(L, sub):
    """The same function as K1's plain version: y, the chunk-entry states and
    the chunks' sums of da, on ragged and whole lengths and other segments."""
    args = [torch.from_numpy(a) for a in _pair_inputs(11, 2, L, 16, 4, 2)]
    want = tscan.ss2d_scan_pair_plain(*args, return_carries=True)
    got = tscan.ss2d_scan_pair_plain(*args, return_carries=True, variant="ssd", sub=sub)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=K1_TOL, atol=K1_TOL)


def test_ssd_wrapper_on_the_cpu():
    """`ss2d_scan_pair(..., variant='ssd')` sends a CPU tensor to the plain
    version at the kernels' chunk and counts no launch; it has no backward and
    refuses a segment that does not divide the chunk."""
    args = [torch.from_numpy(a) for a in _pair_inputs(3, 1, 90, 16, 4, 2)]
    before = scan_cuda.ss2d_scan_pair_ssd.launches
    y, state, sumda = scan_cuda.ss2d_scan_pair(*args, variant="ssd", return_carries=True)
    want = tscan.ss2d_scan_pair_plain(*args, chunk=scan_cuda.CHUNK, return_carries=True,
                                      variant="ssd")
    for g, w in zip((y, state, sumda), want):
        assert torch.equal(g, w)
    assert torch.equal(scan_cuda.ss2d_scan_pair(*args, variant="ssd"), y)
    assert scan_cuda.ss2d_scan_pair_ssd.launches == before
    with pytest.raises(ValueError, match="divide"):
        scan_cuda.ss2d_scan_pair(*args, variant="ssd", sub=7)
    with pytest.raises(ValueError, match="unknown variant"):
        scan_cuda.ss2d_scan_pair(*args, variant="chunked")
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        scan_cuda.ss2d_scan_pair(*args, variant="ssd")


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


def test_ssd_kernel_needs_a_card(monkeypatch):
    """Inputs K5 takes (N=16, R=2, D=64) on the CUDA device type pass every
    check and reach the kernel's loader, which raises on a host without CUDA:
    no fallback to the plain version, no count; N=4 is refused first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [FakeCuda(torch.from_numpy(a)) for a in _pair_inputs(3, 1, 70, 64, 16, 2)]
    before = scan_cuda.ss2d_scan_pair_ssd.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_cuda.ss2d_scan_pair(*args, variant="ssd")
    assert scan_cuda.ss2d_scan_pair_ssd.launches == before
    small = [FakeCuda(torch.from_numpy(a)) for a in _pair_inputs(3, 1, 70, 16, 4, 2)]
    with pytest.raises(ValueError, match="N=16"):
        scan_cuda.ss2d_scan_pair_ssd(*small)
