"""The probes' launch plans (`wavemamba_torch/scripts/gpu_probe.py`) on the CPU.

P4 (`nsum_plan`): the kernel (`csrc/gpu_probe.cu:nsum`) computes its threads'
indices from the plan's `g_per_block` and refuses any other; the map below
repeats its index arithmetic in numpy: block (t, by), thread j holds g = by *
g_per_block + j // cols of (g, t), and of it the V / 4 chunks of 4 d that
start at d = 4 (j % cols + v cols); it is idle where j // cols >= g_per_block
or g >= G. Every (g, t, d) must be held by exactly one thread, and every
16-byte access of x and out must start on a 16-byte boundary.

P1 and P3 (`stream_plan`): the kernels (`csrc/gpu_probe.cu:flat`,
`expchain`, both through `stream_tiles`) refuse a launch whose threads, V, g
a tile or grid are not the plan's; the walk below repeats their index
arithmetic: block b starts at tile (p, j) = (b // tiles_per_g, b %
tiles_per_g), steps by the grid with j carried into p, and thread i of tile
(p, j) holds the V elements at in-block offset j tile + V i of each g = 4 p +
h, h < 4, idle past the block's end and past G. Every
(g, t, nd) must be held by exactly one thread, every 16-byte access start on
a 16-byte boundary, and each element's a offset equal its in-block offset.

The kernels themselves run on the card only (`chip_smoke.py`).
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


def _stream_walk(plan, G, per_g):
    """The index arithmetic of `stream_tiles`, every block at once, one step
    of the walk at a time: (how many threads hold each element of the (G,
    per_g) x, the tiles each block walked, the byte offsets of the first
    warp's accesses of x on the first step). Asserts on the way that each
    block walks its tiles in order, that every 16-byte access of x, out and
    a starts on a 16-byte boundary inside its tensor, and that each
    element's a offset is its in-block offset."""
    tpg, tile, V, gs, grid = (plan[k] for k in ("tiles_per_g", "tile", "V", "g_per_tile", "grid"))
    P = -(-G // gs)
    dp, dj = grid // tpg, grid - grid // tpg * tpg
    b = np.arange(grid)
    p, j = b // tpg, b - b // tpg * tpg
    lane = np.arange(plan["threads"]) * V
    held = np.zeros(G * per_g, np.uint8)
    walked, last = np.zeros(grid, np.int64), np.full(grid, -1, np.int64)
    first_warp = None
    while (p < P).any():
        live = p < P
        tile_no = p * tpg + j
        assert (tile_no[live] > last[live]).all()
        last = np.where(live, tile_no, last)
        walked += live
        off = j[:, None] * tile + lane[None, :]  # (block, thread): the a offset
        for h in range(gs):
            g = (p * gs + h)[:, None]
            on = live[:, None] & (off < per_g) & (g < G)
            start = (g * per_g + off)[on]  # the element an access of x / out starts at
            for e in range(V):
                np.add.at(held, start + e, 1)
            assert (4 * start % 16 == 0).all() and (4 * off[on] % 16 == 0).all()
            assert start.max(initial=0) + V <= G * per_g and off[on].max(initial=0) + V <= per_g
            assert (off[on] == start % per_g).all()
            if first_warp is None:
                first_warp = 4 * (g[0, 0] * per_g + off[0, :32])
        pn, jn = p + dp, j + dj
        carry = jn >= tpg
        p, j = np.where(carry, pn + 1, pn), np.where(carry, jn - tpg, jn)
    return held, walked, first_warp


@pytest.mark.parametrize("G,T,ND,sms,bps", [
    (gp.GRID, gp.T, gp.ND, 132, 4),  # the probe's shape on an H100: P1 at 4 blocks an SM
    (gp.GRID, gp.T, gp.ND, 132, 3),  # P3 at 3
    (6, 3, 1028, 3, 2),    # a ragged last tile (3,084 of 4 x 1,024), a group of 2 g, a grid of 6
    (29, 2, 300, 2, 2),    # 600 offsets: one ragged tile a group, the grid steps 4 groups
    (7, 5, 1000, 132, 8),  # fewer tiles (10) than resident blocks: one tile a block
    (3, 1, 4, 2, 1),       # one thread's worth a g, one group of 3 g
])
def test_stream_plan_covers_every_element_once_aligned(G, T, ND, sms, bps):
    plan = gp.stream_plan(G, T, ND, sms, bps)
    per_g = T * ND
    assert plan["threads"] == 256 and plan["V"] == 4 and plan["g_per_tile"] == 4
    assert plan["tile"] == 1024 and plan["tiles_per_g"] == -(-per_g // 1024)
    assert plan["tiles"] == -(-G // 4) * plan["tiles_per_g"]
    assert plan["grid"] == min(plan["tiles"], sms * bps)
    held, walked, _ = _stream_walk(plan, G, per_g)
    assert (held == 1).all()
    assert walked.min() >= 1 and walked.max() == plan["tiles_per_block"]
    assert walked.sum() == plan["tiles"]


def test_stream_plan_at_the_probe_shape_is_one_wave_of_persistent_blocks():
    """At 4 blocks an SM the H100's 132 SMs hold 528 blocks, which walk the
    32,768 tiles of 4 g x 1,024 offsets 62 or 63 each; a warp's 16-byte
    accesses of one g cover 512 contiguous bytes."""
    plan = gp.stream_plan(gp.GRID, gp.T, gp.ND, 132, 4)
    assert plan["tiles_per_g"] == 1024 and plan["tiles"] == 32768
    assert plan["grid"] == 528 and plan["tiles_per_block"] == 63
    _, _, first_warp = _stream_walk(gp.stream_plan(2, 1, 2048, 1, 1), 2, 2048)
    assert (np.diff(first_warp) == 16).all()


@pytest.mark.parametrize("G,T,ND,sms,bps", [(2, 3, 5, 132, 8), (0, 4, 8, 132, 8),
                                            (2, 4, 8, 0, 8), (2, 4, 8, 132, 0),
                                            (2, 2**16, 2**15, 132, 8)])
def test_stream_plan_refuses_what_the_kernels_do_not_take(G, T, ND, sms, bps):
    with pytest.raises(ValueError, match="stream_plan"):
        gp.stream_plan(G, T, ND, sms, bps)


@pytest.mark.parametrize("name", ["flat", "exp"])
def test_stream_wrappers_raise_without_a_card(monkeypatch, name):
    """P1's and P3's inputs on the CUDA device type pass every check and reach
    the kernels' loader, which raises on a host without CUDA: no fallback to
    the plain version, no launch counted."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, a = (FakeCuda(torch.from_numpy(t)) for t in gp.probe_inputs(name, 1))
    fn = gp.WRAPPERS[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(x, a)
    assert fn.launches == before


def test_p3_cpu_route_tolerance_and_bounds_are_unchanged():
    """A CPU tensor takes P3's plain version, torch.exp K times, with no
    launch; `TOL` and the bounds of P1 and P3 read as before the kernels
    were redesigned (bytes at 3.35 TB/s, the FMA pipe at 67 TFLOP/s, one
    ex2 an exp on the SFU at a sixteenth of it)."""
    x, a = (torch.from_numpy(t) for t in gp.probe_inputs("exp", 1))
    before = gp.probe_exp.launches
    got = gp.probe_exp(x, a, K=3)
    assert gp.probe_exp.launches == before
    want = x
    for _ in range(3):
        want = torch.exp(want * a)
    assert torch.equal(got, want)
    assert gp.PLAIN["exp"] is gp.probe_exp_plain and gp.WRAPPERS["exp"] is gp.probe_exp
    assert gp.TOL["flat"] == 1e-4 and gp.TOL["exp"] == 1e-5
    assert (gp.K_DEFAULT["flat"], gp.K_COMPUTE["flat"], gp.K_DEFAULT["exp"], gp.K_COMPUTE["exp"]) \
        == (48, 384, 16, 128)
    for name, K, ms, by, unit in (("flat", 48, 0.3218, "bytes", "hbm"),
                                  ("flat", 384, 1.5385, "operations", "fma"),
                                  ("exp", 16, 0.5128, "operations", "sfu"),
                                  ("exp", 128, 4.1027, "operations", "sfu")):
        got_ms, got_by, got_unit = gp.bound(name, gp.GRID, K)
        assert (round(got_ms, 4), got_by, got_unit) == (ms, by, unit), name


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_14flatEPKfS2_Pfiiii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   FFMA R4, R4, R8, R12 ;
        /*0030*/                   FFMA R5, R5, R9, R13 ;
        /*0040*/                   IADD3 R2, R2, -0x10, RZ ;
        /*0050*/                   ISETP.GT.AND P0, PT, R2, 0xf, PT ;
        /*0060*/               @P0 BRA 0x20 ;
        /*0070*/                   FFMA R4, R4, R8.reuse, R12 ;
        /*0080*/                   MUFU.EX2 R6, R6 ;
        /*0090*/                   MUFU.EX2 R7, R7 ;
        /*00a0*/                   MUFU.EX2 R3, R3 ;
        /*00b0*/                   IADD3 R2, R2, -0x1, RZ ;
        /*00c0*/               @P0 BRA 0x70 ;
        /*00d0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_18expchainEPKfS2_Pfiiii
        /*0000*/                   FFMA R4, R4, R8, R12 ;
        /*0010*/                   BRA 0x0 ;
"""


@pytest.mark.parametrize("opcode,first,count,per_op", [("FFMA", 0x20, 2, 2.5),
                                                        ("MUFU.EX2", 0x70, 3, 2.0)])
def test_sass_loop_picks_the_loop_by_its_opcode(opcode, first, count, per_op):
    """Of `flat`'s two innermost loops (0x20-0x60 with two FFMAs, 0x70-0xc0
    with one FFMA and three MUFU.EX2), the parser takes the one with the most
    instructions of the opcode it is given, and only `flat`'s function."""
    loop = gp.parse_sass_loop(SASS, "flat", opcode)
    assert loop["opcode"] == opcode and loop["count"] == count
    assert loop["instructions"] == {0x20: 5, 0x70: 6}[first]
    assert loop["per_op"] == per_op
    if opcode == "FFMA":  # R4 / R8 / R12 and R5 / R9 / R13: each all in one bank
        assert loop["ffma"] == 2 and loop["ffma_one_bank"] == 2 and loop["per_fma"] == 2.5
    else:  # R8 is reused, R4 and R12 share a bank
        assert loop["ffma"] == 1 and loop["ffma_one_bank"] == 1 and loop["opcodes"]["MUFU.EX2"] == 3
    with pytest.raises(RuntimeError, match="no loop with LDS"):
        gp.parse_sass_loop(SASS, "flat", "LDS")
