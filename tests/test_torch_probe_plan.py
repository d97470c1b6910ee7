"""P4's launch plan (`wavemamba_torch/scripts/gpu_probe.py:nsum_plan`) on the CPU.

The kernel (`csrc/gpu_probe.cu:nsum`) computes its threads' indices from the
plan's `g_per_block` and refuses any other; the map below repeats its index
arithmetic in numpy: block (t, by), thread j holds g = by * g_per_block +
j // cols of (g, t), and of it the V / 4 chunks of 4 d that start at d =
4 (j % cols + v cols); it is idle where j // cols >= g_per_block or g >= G. Every (g, t, d) must be held by exactly one
thread, and every 16-byte access of x and out must start on a 16-byte
boundary. The kernel itself runs on the card only (`chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

from wavemamba_torch.scripts import gpu_probe as gp

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)


def _index_map(plan, G, T, N, D2):
    """(how many threads hold each (g, t, d), the byte offsets of every
    thread's 16-byte rows of x / out): `nsum`'s index arithmetic."""
    held = np.zeros((G, T, D2), np.int64)
    j = np.arange(plan["threads"])
    gl, col = j // plan["cols"], j % plan["cols"]
    offsets = []
    for by in range(plan["blocks"][1]):
        g = by * plan["g_per_block"] + gl
        on = (gl < plan["g_per_block"]) & (g < G)
        g_on, col_on = g[on], col[on]
        for t in range(plan["blocks"][0]):
            for v in range(plan["V"] // 4):
                d0 = 4 * (col_on + v * plan["cols"])  # the chunk's first d
                for e in range(4):
                    np.add.at(held, (g_on, t, d0 + e), 1)
                row = ((g_on * T + t) * N) * D2 + d0  # (g, t, n = 0, d0) in floats
                offsets.append(4 * (row[:, None] + np.arange(N)[None, :] * D2))
    return held, np.concatenate([o.ravel() for o in offsets])


@pytest.mark.parametrize("G,T,D2", [(gp.GRID, gp.T, gp.D2), (13, 7, 72), (5, 3, 1024), (3, 2, 8)])
def test_nsum_plan_covers_every_element_once_aligned(G, T, D2):
    """At the TPU probe's shape (128 x 512 x 128), at a ragged one (72 d: 9
    threads a row, 14 g a block, 2 threads idle, a last block part-full), at
    the widest D2 a block takes and at the narrowest."""
    plan = gp.nsum_plan(G, T, gp.N, D2)
    assert plan["threads"] == 128 and plan["V"] == 8
    assert plan["cols"] * plan["V"] == D2 and plan["g_per_block"] * plan["cols"] <= plan["threads"]
    assert plan["blocks"] == (T, -(-G // plan["g_per_block"]))
    assert plan["smem_bytes"] == 4 * plan["k_tile"] * gp.N
    held, offsets = _index_map(plan, G, T, gp.N, D2)
    assert (held == 1).all()
    assert (offsets % 16 == 0).all()
    assert offsets.max() + 16 <= 4 * G * T * gp.N * D2  # inside the (G, T, N, D2) tensor


def test_nsum_plan_at_the_tpu_shape_is_two_g_a_warp():
    """At D2 = 128 sixteen threads hold the 128 d of one (g, t), so each
    16-byte row load of a warp reads two runs of 256 contiguous bytes, and a
    block of four warps holds one t of eight g."""
    plan = gp.nsum_plan(gp.GRID, gp.T, gp.N, gp.D2)
    assert plan["cols"] == 16 and plan["g_per_block"] == 8
    assert plan["blocks"] == (gp.T, gp.GRID // 8)
    _, offsets = _index_map(gp.nsum_plan(2, 1, gp.N, gp.D2), 2, 1, gp.N, gp.D2)
    first = offsets.reshape(-1, gp.N)[:16, 0]  # row n = 0 of the first g, chunk 0 of 16 threads
    assert (np.diff(first) == 16).all()


@pytest.mark.parametrize("N,D2", [(8, 128), (16, 68), (16, 0), (16, 1032)])
def test_nsum_plan_refuses_what_the_kernel_does_not_take(N, D2):
    with pytest.raises(ValueError, match="nsum_plan"):
        gp.nsum_plan(2, 4, N, D2)


class FakeCuda:
    """A CPU tensor that claims the CUDA device type, so a CPU-only host
    reaches the wrapper's CUDA path (nothing there reads its data)."""

    def __init__(self, t):
        self.t = t
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return self.t.dim()

    def data_ptr(self):
        return self.t.data_ptr()

    def is_contiguous(self):
        return self.t.is_contiguous()


def test_nsum_wrapper_raises_without_a_card(monkeypatch):
    """Inputs P4 takes on the CUDA device type pass every check and reach the
    kernel's loader, which raises on a host without CUDA: no fallback to the
    plain version, no launch counted."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, c = (FakeCuda(torch.from_numpy(a)) for a in gp.probe_inputs("nsum", 1))
    before = gp.probe_nsum.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.probe_nsum(x, c)
    assert gp.probe_nsum.launches == before
