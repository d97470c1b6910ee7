"""K3's launch geometry (`wavemamba_torch/ops/scan_cuda.py:k3_plan`) at the
shapes `chip_smoke.py`'s k3 phase runs, the wrapper's use of it, and the
check `chip_smoke.py:k3_geometry` makes of it against the card's occupancy
query. Pure Python: the kernel itself runs only on the card, where
`chip_smoke.py` holds the query's residency against this plan."""

import importlib.util
import pathlib
import re

import pytest
import torch
from test_torch_selective_scan import _fake_args

from wavemamba_torch.ops import scan_cuda

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

H100_SMS = 132
SMEM_PER_SM = 233_472  # an H100 SM's shared memory, 228 KB
SMEM_PER_BLOCK = 232_448  # an H100 block's shared-memory limit, 227 KB
SMEM_SCAN = 40_960  # selective_chunk's tiles at N = 16, T = 64
K = 4  # the directions of an SS2D block, one stream each
# chip_smoke.py's k3 cases: the three scan lengths of a 1080p forward (B=1),
# the three LFSS levels of a batch-8 512x512 step, the ragged length.
CASES = [("serve_level1", 1, 552_960), ("serve_level2", 1, 138_240), ("serve_level3", 1, 34_560),
         ("train_level1", 8, 65_536), ("train_level2", 8, 16_384), ("train_level3", 8, 4_096),
         ("ragged", 1, 1_000)]


def _plan(B=8, L=65_536, D=64, N=16, T=scan_cuda.CHUNK):
    return scan_cuda.k3_plan(B, K, L, D, N, T, H100_SMS)


# selective_prefix's workers a lane (one for every 8 chunks, at most 64) and
# its resident blocks an SM at each case: two blocks of 64 workers; smaller
# blocks up to 2,048 threads, 32 blocks or the shared memory.
PREFIX = {"serve_level1": (64, 2), "serve_level2": (64, 2), "serve_level3": (64, 2),
          "train_level1": (64, 2), "train_level2": (32, 4), "train_level3": (8, 16),
          "ragged": (2, 25)}


@pytest.mark.parametrize("name,B,L", CASES)
def test_plan_keeps_its_warps_an_sm_within_shared_memory(name, B, L):
    plan = _plan(B, L)
    nc = -(-L // scan_cuda.CHUNK)
    assert plan["threads"] == 256 and plan["smem_scan"] == SMEM_SCAN <= SMEM_PER_BLOCK
    assert (plan["blocks_per_sm_scan"], plan["warps_per_sm_scan"]) == (4, 32)
    workers, blocks = PREFIX[name]
    assert workers == min(64, -(-nc // 8))
    assert (plan["prefix_threads"], plan["blocks_per_sm_prefix"]) == (16 * workers, blocks)
    assert plan["warps_per_sm_prefix"] == blocks * -(-16 * workers // 32)
    for kind, threads in (("scan", plan["threads"]), ("prefix", plan["prefix_threads"])):
        blocks = plan[f"blocks_per_sm_{kind}"]
        assert blocks * (plan[f"smem_{kind}"] + 1_024) <= SMEM_PER_SM, kind
        assert blocks * threads <= 2_048 and blocks <= 32, kind
    assert plan["grid_scan"] == (nc, B * K, 1) and plan["grid_prefix"] == (64, B * K)
    assert plan["waves_scan"] == pytest.approx(nc * B * K / (4 * H100_SMS))
    # Both shapes of the serve path and of the step fill the card many times over.
    if name != "ragged":
        assert plan["waves_scan"] > 3


def test_plan_counts_the_shared_memory_of_the_source():
    """The tiles of `csrc/selective_scan.cu`: B | C of the chunk [T][2N] and
    (da, u) of each (token, channel of the group) [T][kGroup]; the prefix's
    two [64][16] arrays. The sum is read from the source's
    `scan_smem_floats`, and the source's constants and launch bounds are the
    plan's: four scan blocks an SM, and two prefix blocks of 1,024 threads,
    which hold it to 32 registers, so that threads and shared memory alone
    set the residency of its smaller blocks."""
    source = scan_cuda.SOURCE_K3.read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))
    group, quad = const("kGroup"), const("kQuad")
    assert (group, quad * group) == (scan_cuda.K3_GROUP, scan_cuda.K3_THREADS)
    assert "constexpr int kThreads = kGroup * kQuad;" in source
    body = re.search(r"constexpr int scan_smem_floats\(int N, int T\) \{\s*return ([^;]+);",
                     source).group(1)
    for T in (1, 13, 64):
        want = 4 * eval(body, {"N": 16, "T": T, "kGroup": group})  # noqa: S307 -- the source's own sum
        assert _plan(T=T)["smem_scan"] == want == 4 * (T * 32 + 2 * T * 64)
    assert _plan()["smem_prefix"] == 4 * 2 * const("kPrefixLanes") * const("kPrefixWorkers")
    assert (const("kPrefixLanes"), const("kPrefixWorkers")) == \
        (scan_cuda.K1_PREFIX_LANES, scan_cuda.K1_PREFIX_WORKERS)
    assert const("kScanBlocks") == scan_cuda.K3_SCAN_BLOCKS == _plan()["blocks_per_sm_scan"]
    assert const("kTMax") == scan_cuda.CHUNK
    assert const("kBatch") == scan_cuda.K3_PREFIX_BATCH
    assert const("kPrefixBlocks") * const("kPrefixLanes") * const("kPrefixWorkers") == 2_048
    assert "__launch_bounds__(kThreads, kScanBlocks) selective_chunk" in source
    assert "__launch_bounds__(kPrefixThreads, kPrefixBlocks) selective_prefix" in source
    assert "min(kPrefixWorkers, (nc + kBatch - 1) / kBatch)" in source  # the plan's workers


def test_plan_takes_every_width_up_to_the_limit():
    """Every D from 1 to 256 takes ceil(D / 64) channel groups of one
    selective_chunk block each, at the same shared memory and residency."""
    for D in range(1, scan_cuda.MAX_D_K3 + 1):
        plan = _plan(D=D)
        assert plan["grid_scan"][2] == -(-D // 64), D
        assert plan["grid_prefix"][0] == -(-16 * D // 16), D
        assert (plan["smem_scan"], plan["warps_per_sm_scan"]) == (SMEM_SCAN, 32), D


@pytest.mark.parametrize("kwargs,match", [
    ({"D": scan_cuda.MAX_D_K3 + 1}, f"D<={scan_cuda.MAX_D_K3}"),
    ({"D": 0}, f"D<={scan_cuda.MAX_D_K3}"),
    ({"N": 8}, "N=16"),
    ({"T": 0}, "1 <= T <= 64"),
    ({"T": 65}, "1 <= T <= 64"),
])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _plan(**kwargs)


def test_wrapper_launches_with_the_plan(monkeypatch):
    """`selective_scan_cuda` sizes its launch by `k3_plan` at its shapes, the
    kernel's chunk and the card's SM count (a host without CUDA reaches that
    point through a fake library and device), before it counts a launch."""
    seen = []

    class Planned(Exception):
        pass

    def plan(*args):
        seen.append(args)
        raise Planned

    monkeypatch.setattr(scan_cuda, "_library_k3", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": H100_SMS}))
    monkeypatch.setattr(scan_cuda, "k3_plan", plan)
    before = scan_cuda.selective_scan_cuda.launches
    with pytest.raises(Planned):
        scan_cuda.selective_scan_cuda(*_fake_args(12, 2, K, 130, 64, 16, False))
    assert seen == [(2, K, 130, 64, 16, scan_cuda.CHUNK, H100_SMS)]
    assert scan_cuda.selective_scan_cuda.launches == before


def _occupancy_as_planned(plan):
    return {"threads": plan["threads"], "smem_scan": plan["smem_scan"],
            "blocks_per_sm_pass1": plan["blocks_per_sm_scan"],
            "blocks_per_sm_replay": plan["blocks_per_sm_scan"],
            "prefix_threads": plan["prefix_threads"],
            "blocks_per_sm_prefix": plan["blocks_per_sm_prefix"]}


def test_chip_smoke_geometry_reads_the_card_against_the_plan():
    plan = _plan(1, 552_960)
    geo = chip_smoke.k3_geometry(plan, _occupancy_as_planned(plan))
    kernels = ("selective_chunk<false>", "selective_chunk<true>", "selective_prefix")
    assert geo == {
        "threads": dict(zip(kernels, (256, 256, 1024))),
        "smem_bytes": {"selective_chunk": SMEM_SCAN, "selective_prefix": 8_192},
        "blocks_per_sm": dict(zip(kernels, (4, 4, 2))),
        "warps_per_sm": dict(zip(kernels, (32, 32, 64))),
        "planned_warps_per_sm": dict(zip(kernels, (32, 32, 64))),
        "grid_scan": [8_640, 4, 1], "waves_scan": 8_640 * 4 / (4 * H100_SMS), "grid_prefix": [64, 4]}


@pytest.mark.parametrize("key,value,match", [
    ("blocks_per_sm_pass1", 3, r"selective_chunk<false>: 3 blocks an SM, 4 planned"),
    ("blocks_per_sm_replay", 2, r"selective_chunk<true>: 2 blocks an SM, 4 planned"),
    ("blocks_per_sm_prefix", 1, "selective_prefix: 1 blocks an SM, 2 planned"),
    ("smem_scan", 8_192, "as k3_plan planned"),
    ("threads", 64, "as k3_plan planned"),
])
def test_chip_smoke_geometry_fails_short_of_the_plan(key, value, match):
    """Registers the card reports can cut the residency below what shared
    memory, threads and the launch bounds allow: the check fails rather than
    reporting it."""
    plan = _plan(1, 552_960)
    occ = _occupancy_as_planned(plan)
    occ[key] = value
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.k3_geometry(plan, occ)


@pytest.mark.parametrize("kernel,phase", [
    ("void (anonymous namespace)::selective_chunk<16, false>(float const*, float const*)", "pass1"),
    ("(anonymous namespace)::selective_prefix(float const*, float*, float const*, int, int, int, int)",
     "prefix"),
    ("void (anonymous namespace)::selective_chunk<16, true>(float const*, float const*)", "replay"),
    ("void (anonymous namespace)::chunk_scan<16, 2, true, float, float>(float const*)", None),  # K1
    ("(anonymous namespace)::chunk_prefix(float const*, float*, float const*, int, int, int)", None),
    ("void (anonymous namespace)::bwd_main<16, 64>(float const*, float const*)", None),  # K4
    ("(anonymous namespace)::bwd_prefix(float const*, float*, float const*, int, int, int, int)", None),
])
def test_chip_smoke_names_each_of_k3s_kernels(kernel, phase):
    """The k3 rows' `phases_ms` sum the profiler's device time by these names."""
    assert chip_smoke.k3_phase_of(kernel) == phase
