"""K1's launch geometry (`wavemamba_torch/ops/scan_cuda.py:k1_plan`) at the
shapes the serve and training paths give it, the wrapper's use of it, and
the check `chip_smoke.py:k1_geometry` makes of it against the card's
occupancy query. Pure Python: the kernel itself runs only on the card, where
`chip_smoke.py` holds the query's residency against this plan."""

import importlib.util
import pathlib
import re

import pytest
import torch
from test_torch_scan import FakeCuda, _pair_inputs

from wavemamba_torch.ops import scan_cuda
from wavemamba_torch.utils import cxx

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

H100_SMS = 132
SMEM_PER_BLOCK = 232_448  # an H100 block's shared-memory limit, 227 KB
SMEM_SCAN = 68_608  # chunk_scan's tiles at D = 64, N = 16, R = 2, T = 64
# The three LFSS levels of a 1080p forward (B = 1) and of a batch-8 512x512
# training step, a ragged length, and the column stream of a 1080p level 3
# (144 x 240 tokens, the length of a row stream).
CASES = [("serve_level1", 1, 552_960), ("serve_level2", 1, 138_240), ("serve_level3", 1, 34_560),
         ("train_level1", 8, 65_536), ("train_level2", 8, 16_384), ("train_level3", 8, 4_096),
         ("ragged", 1, 34_560 + 37), ("columns", 1, 144 * 240)]


@pytest.mark.parametrize("name,B,L", CASES)
def test_plan_holds_three_scan_blocks_an_sm_within_shared_memory(name, B, L):
    plan = scan_cuda.k1_plan(B, L, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)
    nc = -(-L // scan_cuda.CHUNK)
    assert plan["threads"] == 256 and plan["smem_scan"] == SMEM_SCAN <= SMEM_PER_BLOCK
    assert (plan["blocks_per_sm_scan"], plan["warps_per_sm_scan"]) == (3, 24)
    assert (plan["prefix_threads"], plan["blocks_per_sm_prefix"], plan["warps_per_sm_prefix"]) \
        == (1024, 1, 32)
    assert plan["grid_scan"] == (nc, B, 1) and plan["grid_prefix"] == (64, 2, B)
    assert plan["waves_scan"] == pytest.approx(nc * B / (3 * H100_SMS))
    # pass 1 leaves x_dbl of every token and direction, [dt (padded to 4) | B | C]
    assert plan["xdbl_shape"] == (B, 2, L, 36)


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_plan_fits_every_dt_rank_the_kernel_takes(R):
    for D in (16, 64, 100, 128):
        plan = scan_cuda.k1_plan(8, 65_536, D, 16, R, scan_cuda.CHUNK, H100_SMS)
        assert plan["smem_scan"] <= SMEM_PER_BLOCK
        assert plan["blocks_per_sm_scan"] >= (3 if D <= 64 else 2)
        assert plan["grid_scan"][2] == (1 if D <= 64 else 2)


def test_plan_counts_the_shared_memory_of_the_source():
    """The tiles of `csrc/ss2d_scan.cu`: the x tile [T][W] with W = 64 x groups
    + 4, x_dbl [2][T][4 + 2N], and one region for wx [2][R + 2N][W] (pass 1)
    and then da [2][T][64]; chunk_prefix's two [64][16] arrays. The source's
    constants (some in the header it shares with K5, `ss2d_scan_common.cuh`),
    and the resident blocks its launch bounds ask for, are the plan's."""
    T = 64
    for D, R, W in ((64, 2, 68), (128, 4, 132), (1, 1, 68)):
        J = R + 32
        want = 4 * (T * W + 2 * T * 36 + max(2 * J * W, 2 * T * 64))
        assert scan_cuda.k1_plan(1, 1000, D, 16, R, T, H100_SMS)["smem_scan"] == want
    assert scan_cuda.k1_plan(1, 1000, 128, 16, 4, T, H100_SMS)["smem_scan"] == 90_240
    assert scan_cuda.k1_plan(1, 1000, 64, 16, 2, T, H100_SMS)["smem_prefix"] == 4 * 2 * 64 * 16
    source = scan_cuda.SOURCE.read_text() + (cxx.CSRC / "ss2d_scan_common.cuh").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))
    assert const("kGroup") == scan_cuda.K1_GROUP
    assert (const("kPrefixLanes"), const("kPrefixWorkers")) == \
        (scan_cuda.K1_PREFIX_LANES, scan_cuda.K1_PREFIX_WORKERS)
    assert const("kScanBlocks") == scan_cuda.K1_SCAN_BLOCKS == scan_cuda.k1_plan(
        1, 1000, 64, 16, 2, T, H100_SMS)["blocks_per_sm_scan"]
    assert "__launch_bounds__(kThreads, kScanBlocks) chunk_scan" in source
    assert "__launch_bounds__(kPrefixThreads) chunk_prefix" in source  # 64 registers: one block
    assert scan_cuda.K1_PREFIX_BLOCKS == 1


@pytest.mark.parametrize("shape,match", [
    ((64, 8, 2, 64), "N=16"), ((64, 16, 0, 64), "1<=R<=4"), ((64, 16, 5, 64), "1<=R<=4"),
    ((129, 16, 2, 64), "D<=128"), ((64, 16, 2, 128), "T <= 64"), ((64, 16, 2, 6), "multiple of 4"),
])
def test_plan_refuses_what_the_kernel_does_not_take(shape, match):
    D, N, R, T = shape
    with pytest.raises(ValueError, match=match):
        scan_cuda.k1_plan(1, 1000, D, N, R, T, H100_SMS)


def test_wrapper_launches_with_the_plan(monkeypatch):
    """`ss2d_scan_pair` sizes its launch by `k1_plan` at its shapes, the
    kernel's chunk and the card's SM count (a host without CUDA reaches that
    point through a fake library and device), before it counts a launch."""
    seen = []

    class Planned(Exception):
        pass

    def plan(*args):
        seen.append(args)
        raise Planned

    monkeypatch.setattr(scan_cuda, "_library", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": H100_SMS}))
    monkeypatch.setattr(scan_cuda, "k1_plan", plan)
    args = [FakeCuda(torch.from_numpy(a)) for a in _pair_inputs(4, 2, 130, 64, 16, 2)]
    before = scan_cuda.ss2d_scan_pair.launches
    with pytest.raises(Planned):
        scan_cuda.ss2d_scan_pair(*args)
    assert seen == [(2, 130, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)]
    assert scan_cuda.ss2d_scan_pair.launches == before


def _occupancy_as_planned(plan):
    return {"threads": plan["threads"], "smem_scan": plan["smem_scan"],
            "blocks_per_sm_pass1": plan["blocks_per_sm_scan"],
            "blocks_per_sm_replay": plan["blocks_per_sm_scan"],
            "prefix_threads": plan["prefix_threads"],
            "blocks_per_sm_prefix": plan["blocks_per_sm_prefix"]}


def test_chip_smoke_geometry_reads_the_card_against_the_plan():
    plan = scan_cuda.k1_plan(1, 552_960, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)
    geo = chip_smoke.k1_geometry(plan, _occupancy_as_planned(plan))
    kernels = ("chunk_scan<false>", "chunk_scan<true>", "chunk_prefix")
    assert geo == {
        "threads": dict(zip(kernels, (256, 256, 1024))),
        "smem_bytes": {"chunk_scan": SMEM_SCAN, "chunk_prefix": 8_192},
        "blocks_per_sm": dict(zip(kernels, (3, 3, 1))),
        "warps_per_sm": dict(zip(kernels, (24, 24, 32))),
        "planned_warps_per_sm": dict(zip(kernels, (24, 24, 32))),
        "grid_scan": [8_640, 1, 1], "waves_scan": 8_640 / (3 * H100_SMS), "grid_prefix": [64, 2, 1]}


@pytest.mark.parametrize("key,value,match", [
    ("blocks_per_sm_pass1", 2, r"chunk_scan<false>: 2 blocks an SM, 3 planned"),
    ("blocks_per_sm_replay", 2, r"chunk_scan<true>: 2 blocks an SM, 3 planned"),
    ("blocks_per_sm_prefix", 0, "chunk_prefix: 0 blocks an SM, 1 planned"),
    ("smem_scan", 50_000, "as k1_plan planned"),
])
def test_chip_smoke_geometry_fails_short_of_the_plan(key, value, match):
    """Registers the card reports can cut the residency below what shared
    memory and threads allow: the check fails rather than reporting it."""
    plan = scan_cuda.k1_plan(1, 552_960, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)
    occ = _occupancy_as_planned(plan)
    occ[key] = value
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.k1_geometry(plan, occ)


@pytest.mark.parametrize("kernel,phase", [
    ("void (anonymous namespace)::chunk_scan<16, 2, false, float>(float const*, float const*)", "pass1"),
    ("void (anonymous namespace)::chunk_scan<16, 2, true, __nv_bfloat16>(__nv_bfloat16 const*)",
     "replay"),
    ("(anonymous namespace)::chunk_prefix(float const*, float*, float const*, int, int, int)", "prefix"),
    ("void (anonymous namespace)::chunk_scan_ssd<16, 2>(float const*)", None),  # K5
    ("void (anonymous namespace)::selective_chunk<16, false>(float const*)", None),  # K3
])
def test_chip_smoke_names_each_of_k1s_kernels(kernel, phase):
    """The k1 rows' `phases_ms` sum the profiler's device time by these names."""
    assert chip_smoke.k1_phase_of(kernel) == phase
