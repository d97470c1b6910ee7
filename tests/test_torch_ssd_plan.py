"""K5's launch geometry (`wavemamba_torch/ops/scan_cuda.py:k5_plan`) at the
shapes `chip_smoke.py`'s k5 phase runs, its refusals, the wrapper's use of
it, and the check `chip_smoke.py:k5_geometry` makes of it against the card's
occupancy query; and CPU transcriptions of the kernel's thread layout (which
thread holds which (direction, channel, state), the order of y's sums over
the quad) and of its segment walk (`csrc/ss2d_scan_ssd.cu`), held against the
plain version. Pure Python: the kernel itself runs only on the card, where
`chip_smoke.py` holds the query's residency against this plan."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
from test_torch_scan import FakeCuda, _pair_inputs

from wavemamba_torch.ops import scan as tscan
from wavemamba_torch.ops import scan_cuda

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

H100_SMS = 132
SMEM_PER_BLOCK = 232_448  # an H100 block's shared-memory limit, 227 KB
SMEM_SCAN = 68_608  # chunk_scan_ssd's tiles at D = 64, N = 16, R = 2, T = 64: K1's
SOURCE = scan_cuda.SOURCE_K5.read_text()
# chip_smoke.py's k5 cases: the three LFSS levels of a 1080p forward (B = 1)
# and the ragged length.
CASES = [("level1", 552_960), ("level2", 138_240), ("level3", 34_560), ("ragged", 34_560 + 37)]


def _plan(B=1, L=552_960, D=64, N=16, R=2, T=scan_cuda.CHUNK, S=8):
    return scan_cuda.k5_plan(B, L, D, N, R, T, S, H100_SMS)


@pytest.mark.parametrize("name,L", CASES)
def test_plan_holds_three_scan_blocks_an_sm_within_shared_memory(name, L):
    plan = _plan(L=L)
    nc = -(-L // scan_cuda.CHUNK)
    assert plan["threads"] == 256 and plan["smem_scan"] == SMEM_SCAN <= SMEM_PER_BLOCK
    assert (plan["blocks_per_sm_scan"], plan["warps_per_sm_scan"]) == (3, 24)
    assert 3 * (plan["smem_scan"] + 1_024) <= 233_472  # the SM's 228 KB
    assert (plan["prefix_threads"], plan["blocks_per_sm_prefix"], plan["warps_per_sm_prefix"]) \
        == (1024, 1, 32)
    assert plan["grid_scan"] == (nc, 1, 1) and plan["grid_prefix"] == (64, 2, 1)
    assert plan["waves_scan"] == pytest.approx(nc / (3 * H100_SMS))
    # pass 1 leaves x_dbl of every token and direction, [dt (padded to 4) | B | C]
    assert plan["xdbl_shape"] == (1, 2, L, 36) and plan["sub"] == 8


def test_plan_is_k1s_layout_and_the_sources():
    """K5 shares K1's tiles and chunk prefix (`ss2d_scan_common.cuh`): the
    same plan at every width and dt rank, and the source's launch bounds ask
    for the plan's resident blocks."""
    for D in (1, 16, 64, 100, 128):
        for R in (1, 2, 3, 4):
            k1 = scan_cuda.k1_plan(2, 1000, D, 16, R, 64, H100_SMS)
            assert {k: v for k, v in _plan(2, 1000, D, R=R).items() if k != "sub"} == k1
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))
    assert const("kScanBlocks") == scan_cuda.K5_SCAN_BLOCKS == _plan()["blocks_per_sm_scan"]
    assert '#include "ss2d_scan_common.cuh"' in SOURCE
    assert "__launch_bounds__(kThreads, kScanBlocks) chunk_scan_ssd" in SOURCE
    # the entry refuses a segment that does not divide the chunk, and any
    # shared memory but the plan's
    assert "S < 1 || T % S ||" in SOURCE
    assert "smem != (int)sizeof(float) * scan_smem_floats(D, N, R, T)" in SOURCE


@pytest.mark.parametrize("kwargs,match", [
    ({"N": 8}, "N=16"), ({"R": 0}, "1<=R<=4"), ({"R": 5}, "1<=R<=4"), ({"D": 129}, "D<=128"),
    ({"S": 7}, "sub=7 must divide"), ({"S": 0}, "sub=0 must divide"), ({"S": 128}, "sub=128"),
    ({"T": 66, "S": 2}, "T <= 64"),
])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _plan(**kwargs)


def test_wrapper_launches_with_the_plan(monkeypatch):
    """`ss2d_scan_pair(..., variant='ssd')` sizes its launch by `k5_plan` at
    its shapes, the kernel's chunk, the segment and the card's SM count (a
    host without CUDA reaches that point through a fake library and device),
    before it counts a launch."""
    seen = []

    class Planned(Exception):
        pass

    def plan(*args):
        seen.append(args)
        raise Planned

    monkeypatch.setattr(scan_cuda, "_library_k5", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": H100_SMS}))
    monkeypatch.setattr(scan_cuda, "k5_plan", plan)
    args = [FakeCuda(torch.from_numpy(a)) for a in _pair_inputs(4, 2, 130, 64, 16, 2)]
    before = scan_cuda.ss2d_scan_pair_ssd.launches
    with pytest.raises(Planned):
        scan_cuda.ss2d_scan_pair(*args, variant="ssd", sub=16)
    assert seen == [(2, 130, 64, 16, 2, scan_cuda.CHUNK, 16, H100_SMS)]
    assert scan_cuda.ss2d_scan_pair_ssd.launches == before


def _occupancy_as_planned(plan):
    return {"threads": plan["threads"], "smem_scan": plan["smem_scan"],
            "blocks_per_sm_pass1": plan["blocks_per_sm_scan"],
            "blocks_per_sm_replay": plan["blocks_per_sm_scan"],
            "prefix_threads": plan["prefix_threads"],
            "blocks_per_sm_prefix": plan["blocks_per_sm_prefix"]}


def test_chip_smoke_geometry_reads_the_card_against_the_plan():
    plan = _plan()
    geo = chip_smoke.k5_geometry(plan, _occupancy_as_planned(plan))
    kernels = ("chunk_scan_ssd<false>", "chunk_scan_ssd<true>", "chunk_prefix")
    assert geo == {
        "threads": dict(zip(kernels, (256, 256, 1024))),
        "smem_bytes": {"chunk_scan_ssd": SMEM_SCAN, "chunk_prefix": 8_192},
        "blocks_per_sm": dict(zip(kernels, (3, 3, 1))),
        "warps_per_sm": dict(zip(kernels, (24, 24, 32))),
        "planned_warps_per_sm": dict(zip(kernels, (24, 24, 32))),
        "grid_scan": [8_640, 1, 1], "waves_scan": 8_640 / (3 * H100_SMS), "grid_prefix": [64, 2, 1]}


@pytest.mark.parametrize("key,value,match", [
    ("blocks_per_sm_pass1", 2, r"chunk_scan_ssd<false>: 2 blocks an SM, 3 planned"),
    ("blocks_per_sm_replay", 2, r"chunk_scan_ssd<true>: 2 blocks an SM, 3 planned"),
    ("blocks_per_sm_prefix", 0, "chunk_prefix: 0 blocks an SM, 1 planned"),
    ("smem_scan", 35_072, "as k5_plan planned"),
    ("threads", 128, "as k5_plan planned"),
])
def test_chip_smoke_geometry_fails_short_of_the_plan(key, value, match):
    """Registers the card reports can cut the residency below what shared
    memory and threads allow: the check fails rather than reporting it."""
    plan = _plan()
    occ = _occupancy_as_planned(plan)
    occ[key] = value
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.k5_geometry(plan, occ)


@pytest.mark.parametrize("kernel,phase", [
    ("void (anonymous namespace)::chunk_scan_ssd<16, 2, false, float, float>(float const*)", "pass1"),
    ("void (anonymous namespace)::chunk_scan_ssd<16, 2, true, __nv_bfloat16, float>"
     "(__nv_bfloat16 const*)", "replay"),
    ("(anonymous namespace)::chunk_prefix(float const*, float*, float const*, int, int, int)", "prefix"),
    ("void (anonymous namespace)::chunk_scan<16, 2, true, float, float>(float const*)", None),  # K1
    ("void (anonymous namespace)::selective_chunk<16, false>(float const*)", None),  # K3
])
def test_chip_smoke_names_each_of_k5s_kernels(kernel, phase):
    """The k5 rows' `phases_ms` sum the profiler's device time by these names;
    K1's own names do not take K5's scan kernels."""
    assert chip_smoke.k5_phase_of(kernel) == phase
    if "chunk_scan_ssd" in kernel:
        assert chip_smoke.k1_phase_of(kernel) is None


# The kernel's thread layout, transcribed: thread tid of a 256-thread block.
LAYOUT = "const int k = tid >> 7, q = tid & 3, p = (tid >> 2) & (kPairs - 1);"


def _thread(tid, g0=0):
    """(direction, its two channels, its four states, whether it writes y)."""
    k, q, p = tid >> 7, tid & 3, (tid >> 2) & 31
    dl = 2 * p
    return k, (g0 + dl, g0 + dl + 1), tuple(4 * q + i for i in range(4)), q < 2


@pytest.mark.parametrize("D", [64, 100, 128])
def test_quad_partition_covers_each_state_once(D):
    """Every (direction, channel, state) of every channel group falls to one
    thread, and every (direction, channel) to one writer of y: the lane of
    its quad whose shuffle sum ends with that channel (q = 0 the pair's
    first, q = 1 its second)."""
    assert LAYOUT in SOURCE and "const bool writer = q < 2 && g0 + dl + (q & 1) < D;" in SOURCE
    held, written = {}, {}
    for g0 in range(0, D, 64):
        for tid in range(256):
            k, chans, states, writer = _thread(tid, g0)
            for d in chans:
                if d >= D:
                    continue
                for n in states:
                    held[k, d, n] = held.get((k, d, n), 0) + 1
            d = chans[tid & 1]
            if writer and d < D:
                written[k, d] = written.get((k, d), 0) + 1
    assert held == {(k, d, n): 1 for k in range(2) for d in range(D) for n in range(16)}
    assert written == {(k, d): 1 for k in range(2) for d in range(D)}


def test_quad_shuffle_sums_each_channel_in_one_order():
    """y's sum over n: each lane holds partial sums a[0], a[1] of its four
    states for the pair's two channels; two xor-shuffles (1, then 2) leave
    channel 0's whole sum on lanes 0 and 2 and channel 1's on lanes 1 and 3,
    each pair of lanes adding the same terms in the same order, so the two
    hold the same bits."""
    assert "float sum = (odd ? a[1] : a[0]) + __shfl_xor_sync(kFull, odd ? a[0] : a[1], 1);" in SOURCE
    assert "sum += __shfl_xor_sync(kFull, sum, 2);" in SOURCE
    rs = np.random.RandomState(0)
    a = rs.randn(4, 2).astype(np.float32) * np.float32(1e3)  # lane q's (a[0], a[1])
    first = [np.float32(a[q, q & 1] + a[q ^ 1, q & 1]) for q in range(4)]  # xor 1: the lane's partner
    total = [np.float32(first[q] + first[q ^ 2]) for q in range(4)]  # xor 2
    for q in range(4):
        assert total[q] == pytest.approx(a[:, q & 1].sum(dtype=np.float64), rel=1e-6)
    assert total[0].tobytes() == total[2].tobytes() and total[1].tobytes() == total[3].tobytes()


def _segment_walk(x, wx, dtw, bias, A, dsk, T=64, S=8):
    """The kernel's arithmetic, transcribed in float64: pass 1 scans each chunk
    from h = 0 segment by segment (1 / G at every token, G at a segment's last),
    the prefix chains the chunks' end states by exp(A * sumda), the replay
    reruns each chunk from its entering state (G and 1 / G at every token).
    Each member walks its chunk in processing order; segments start at the
    chunk's first processed token. Returns y (B, 2, L, D), state, sumda."""
    x, wx, dtw, bias, A, dsk = (np.asarray(t, np.float64) for t in (x, wx, dtw, bias, A, dsk))
    B, L, D = x.shape
    R, N = dtw.shape[1], A.shape[1]
    nc = -(-L // T)
    y = np.zeros((B, 2, L, D))
    state = np.zeros((B, 2, nc, N, D))
    sumda = np.zeros((B, 2, nc, D))
    for k in range(2):
        xd = x @ wx[k]  # (B, L, R + 2N)
        z = xd[..., :R] @ dtw[k] + bias[k]
        da = np.where(z > 20, z, np.log1p(np.exp(np.minimum(z, 20))))
        Bs, Cs = xd[..., R:R + N], xd[..., R + N:]
        order = range(nc) if k == 0 else range(nc - 1, -1, -1)
        for replay in (False, True):
            H_in = np.zeros((B, N, D))
            for c in order:
                tc = min(T, L - c * T)
                toks = [c * T + (s if k == 0 else tc - 1 - s) for s in range(tc)]
                H = state[:, k, c].copy() if replay else np.zeros((B, N, D))
                for s0 in range(0, tc, S):
                    cl, cums = np.zeros((B, D)), np.zeros((B, N, D))
                    for t in toks[s0:s0 + S]:
                        cl = cl + da[:, t]
                        m = cl[:, None, :] * A[k]
                        cums = cums + (da[:, t] * x[:, t])[:, None, :] * Bs[:, t, :, None] * np.exp(-m)
                        if replay:
                            h = np.exp(m) * (H + cums)
                            y[:, k, t] = (Cs[:, t, :, None] * h).sum(1) + dsk[k] * x[:, t]
                    H = h if replay else np.exp(cl[:, None, :] * A[k]) * (H + cums)
                if not replay:  # end state, then the prefix's entering state
                    sumda[:, k, c] = da[:, toks].sum(1)
                    state[:, k, c] = H_in
                    H_in = np.exp(A[k] * sumda[:, k, c][:, None, :]) * H_in + H
    return y, state, sumda


@pytest.mark.parametrize("B,L,D,N,R,S", [(1, 150, 8, 16, 2, 8), (2, 64, 4, 16, 1, 16), (1, 37, 4, 4, 3, 4)])
def test_segment_walk_is_the_plain_version(B, L, D, N, R, S):
    """The transcription of the kernel's two passes and prefix against K5's
    plain version (`ss2d_scan_pair_plain(..., variant='ssd')`): y and both
    carries, on ragged and whole chunks and other segments."""
    args = _pair_inputs(9, B, L, D, N, R)
    want = tscan.ss2d_scan_pair_plain(*map(torch.from_numpy, args), chunk=64, return_carries=True,
                                      variant="ssd", sub=S)
    for got, w in zip(_segment_walk(*args, S=S), want):
        np.testing.assert_allclose(got, w.double().numpy(), rtol=1e-5, atol=1e-5)


PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114chunk_scan_ssdILi16ELi2ELb1EffEEvPKT2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114chunk_scan_ssdILi16ELi2ELb1EffEEvPKT2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114chunk_scan_ssdILi16ELi2ELb1E13__nv_bfloat16fEEvPKT2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114chunk_scan_ssdILi16ELi2ELb1E13__nv_bfloat16fEEvPKT2_
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114chunk_scan_ssdILi16ELi2ELb0EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114chunk_scan_ssdILi16ELi2ELb0EEEvPKfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112chunk_prefixEPKfPfS1_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112chunk_prefixEPKfPfS1_iii
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8192 bytes smem
"""


@pytest.mark.parametrize("first,want", [
    (False, {"replay": (80, 0, 0), "prefix": (64, 8, 12)}),  # the float32 pair of today's source
    (True, {"pass1": (79, 0, 0), "prefix": (64, 8, 12)}),    # the first design's <16, 2, false>
])
def test_k5_variants_reads_each_interfaces_registers(first, want):
    """`scripts/k5_variants.py` reads the registers and spills of the <16, 2>
    passes of the interface it bound (float32 streams only: not the bf16
    pair) and of chunk_prefix from a `-Xptxas -v` report."""
    from wavemamba_torch.scripts import k5_variants

    assert k5_variants.ptxas_resources(PTXAS, k5_variants.TEMPLATES[first]) == want


def test_k5_variants_needs_a_card(monkeypatch):
    from wavemamba_torch.scripts import k5_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="times the card"):
        k5_variants.main([])
