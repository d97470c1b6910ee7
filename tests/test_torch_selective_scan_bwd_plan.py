"""K4's launch geometry (`wavemamba_torch/ops/scan_cuda.py:k4_plan`) at the
shapes `chip_smoke.py`'s k4 phase runs, the wrapper's use of it, and the
check `chip_smoke.py:k4_geometry` makes of it against the card's occupancy
query. Pure Python: the kernel itself runs only on the card, where
`chip_smoke.py` holds the query's residency against this plan."""

import importlib.util
import pathlib

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
SMEM_PER_BLOCK = 232_448  # an H100 block's shared-memory limit, 227 KB
K = 4  # the directions of an SS2D block, one stream each
# chip_smoke.py's k3 / k4 cases: the three scan lengths of a 1080p forward
# (B=1), the three LFSS levels of a batch-8 512x512 step, the ragged length.
CASES = [("serve_level1", 1, 552_960), ("serve_level2", 1, 138_240), ("serve_level3", 1, 34_560),
         ("train_level1", 8, 65_536), ("train_level2", 8, 16_384), ("train_level3", 8, 4_096),
         ("ragged", 1, 1_000)]


def _plan(B=8, L=65_536, D=64, N=16, T=scan_cuda.CHUNK):
    return scan_cuda.k4_plan(B, K, L, D, N, T, H100_SMS)


@pytest.mark.parametrize("name,B,L", CASES)
def test_plan_keeps_its_warps_an_sm_within_shared_memory(name, B, L):
    plan = _plan(B, L)
    assert plan["threads"] == 256
    for kernel, warps in (("local", 32), ("main", 16)):
        assert plan[f"smem_{kernel}"] <= SMEM_PER_BLOCK, (kernel, plan)
        assert plan[f"warps_per_sm_{kernel}"] >= warps, (kernel, plan)
    nc = -(-L // scan_cuda.CHUNK)
    # Every block of bwd_main has a chunk, and all K * gx of them reside at once.
    assert 1 <= plan["gx"] <= min(B * nc, H100_SMS * plan["blocks_per_sm_main"] // K)
    if name == "train_level1":  # the grid fills the card in one whole wave
        assert plan["gx"] * K == H100_SMS * plan["blocks_per_sm_main"]


def test_plan_counts_the_shared_memory_of_the_source():
    """The tiles of `csrc/selective_scan_bwd.cu` at D <= 64 (a block of 64
    channels), T = 64, N = 16: bwd_main holds B and C of the chunk, (da, u,
    sigmoid(z), dy) of each (token, channel), h at the head of each of the
    8 sub-tiles, and the 8 warps' sums over channels of a sub-tile (8 tokens,
    dB and dC); bwd_local C of the chunk and (da, dy)."""
    T, N, DM = 64, 16, 64
    main = T * 2 * N + 4 * T * DM + (T // 8) * DM * N + (DM // 8) * 8 * 2 * N
    local = T * N + 2 * T * DM
    plan = _plan()
    assert (plan["smem_main"], plan["smem_local"]) == (4 * main, 4 * local) == (114_688, 36_864)
    assert (plan["blocks_per_sm_main"], plan["blocks_per_sm_local"]) == (2, 4)


@pytest.mark.parametrize("D,threads", [(1, 256), (64, 256), (65, 512), (128, 512)])
def test_plan_takes_every_width_up_to_the_limit(D, threads):
    """Widths up to 64 take blocks of 64 channels, wider ones of 128; both
    fit a block's shared memory and keep 16 / 32 warps an SM."""
    plan = _plan(D=D)
    assert plan["threads"] == threads
    assert max(plan["smem_local"], plan["smem_main"]) <= SMEM_PER_BLOCK
    assert plan["warps_per_sm_main"] >= 16 and plan["warps_per_sm_local"] >= 32


@pytest.mark.parametrize("kwargs,match", [
    ({"D": scan_cuda.MAX_D_K4 + 1}, f"D<={scan_cuda.MAX_D_K4}"),
    ({"N": 8}, "N=16"),
    ({"T": 12}, "multiple of 8"),
])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _plan(**kwargs)


def test_wrapper_launches_with_the_plan(monkeypatch):
    """`selective_scan_cuda_bwd` sizes its grid by `k4_plan` at its shapes
    and the card's SM count (a host without CUDA reaches that point through a
    fake library and device)."""
    seen = []

    class Planned(Exception):
        pass

    def plan(*args):
        seen.append(args)
        raise Planned

    monkeypatch.setattr(scan_cuda, "_library_k4", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": H100_SMS}))
    monkeypatch.setattr(scan_cuda, "k4_plan", plan)
    before = scan_cuda.selective_scan_cuda_bwd.launches
    with pytest.raises(Planned):
        scan_cuda.selective_scan_cuda_bwd(*_fake_args(11, 2, K, 130, 64, 16, True))
    assert seen == [(2, K, 130, 64, 16, scan_cuda.CHUNK, H100_SMS)]
    assert scan_cuda.selective_scan_cuda_bwd.launches == before


def _occupancy_as_planned(plan):
    return {key: plan[key] for key in ("threads", "smem_local", "smem_main",
                                       "blocks_per_sm_local", "blocks_per_sm_main")}


def test_chip_smoke_geometry_reads_the_card_against_the_plan():
    plan = _plan()
    geo = chip_smoke.k4_geometry(plan, _occupancy_as_planned(plan))
    assert geo == {"threads": 256, "smem_bytes": {"bwd_local": 36_864, "bwd_main": 114_688},
                   "blocks_per_sm": {"bwd_local": 4, "bwd_main": 2},
                   "warps_per_sm": {"bwd_local": 32, "bwd_main": 16},
                   "planned_warps_per_sm": {"bwd_local": 32, "bwd_main": 16},
                   "gx": 66}


@pytest.mark.parametrize("key,value,match", [
    ("blocks_per_sm_main", 1, "bwd_main: 1 blocks an SM, 2 planned"),
    ("blocks_per_sm_local", 3, "bwd_local: 3 blocks an SM, 4 planned"),
    ("smem_main", 200_000, "as k4_plan planned"),
])
def test_chip_smoke_geometry_fails_short_of_the_plan(key, value, match):
    """Registers the card reports can cut the residency below what shared
    memory, threads and the launch bounds allow: the check fails rather than
    reporting it."""
    plan = _plan()
    occ = _occupancy_as_planned(plan)
    occ[key] = value
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.k4_geometry(plan, occ)


@pytest.mark.parametrize("kernel,phase", [
    ("void (anonymous namespace)::bwd_local<16, 64>(float const*, float const*)", "local"),
    ("(anonymous namespace)::bwd_prefix(float const*, float*, float const*, int, int, int, int)",
     "prefix"),
    ("void (anonymous namespace)::bwd_main<16, 64>(float const*, float const*)", "main"),
    ("(anonymous namespace)::bwd_reduce(float const*, float*, int, int)", "reduce"),
    ("(anonymous namespace)::selective_prefix(float const*, float*, float const*, int, int, int, int)",
     None),  # K3
    ("void (anonymous namespace)::selective_chunk<16, true>(float const*)", None),  # K3
])
def test_chip_smoke_names_each_of_k4s_kernels(kernel, phase):
    """The k4 rows' `phases_ms` sum the profiler's device time by these names."""
    assert chip_smoke.k4_phase_of(kernel) == phase
