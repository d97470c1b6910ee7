"""K2's launch geometry (`wavemamba_torch/ops/scan_cuda.py:k2_plan`) at the
shapes `chip_smoke.py`'s k2 phase runs, the wrapper's use of it, and the
check `chip_smoke.py:k2_geometry` makes of it against the card's occupancy
query. Pure Python: the kernel itself runs only on the card, where
`chip_smoke.py` holds the query's residency against this plan."""

import importlib.util
import pathlib

import pytest
import torch
from test_torch_scan_bwd import _fake_bwd_args

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
# chip_smoke.py's k2 cases: the three LFSS levels of a batch-8 512x512 step,
# the ragged length and the column stream (48 x 80 tokens).
CASES = [("level1", 8, 65536), ("level2", 8, 16384), ("level3", 8, 4096),
         ("ragged", 1, 1000), ("columns", 1, 3840)]


@pytest.mark.parametrize("name,B,L", CASES)
def test_plan_holds_sixteen_warps_an_sm_within_shared_memory(name, B, L):
    plan = scan_cuda.k2_plan(B, L, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)
    assert plan["threads"] == 512
    for kernel in ("local", "main"):
        assert plan[f"smem_{kernel}"] <= SMEM_PER_BLOCK, (kernel, plan)
        assert plan[f"blocks_per_sm_{kernel}"] >= 1, (kernel, plan)
        assert plan[f"warps_per_sm_{kernel}"] >= 16, (kernel, plan)
    nc = -(-L // scan_cuda.CHUNK)
    # Every block of bwd_main has a chunk, and all of them reside at once.
    assert 1 <= plan["gx"] <= min(B * nc, H100_SMS * plan["blocks_per_sm_main"])
    if name == "level1":  # the grid fills the card in one whole wave
        assert plan["gx"] == H100_SMS * plan["blocks_per_sm_main"]


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_plan_fits_every_dt_rank_the_kernel_takes(R):
    plan = scan_cuda.k2_plan(8, 65536, 64, 16, R, scan_cuda.CHUNK, H100_SMS)
    assert max(plan["smem_local"], plan["smem_main"]) <= SMEM_PER_BLOCK
    assert plan["warps_per_sm_main"] >= 16 and plan["warps_per_sm_local"] >= 16


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="D <= 64"):
        scan_cuda.k2_plan(1, 64, 128, 16, 2, scan_cuda.CHUNK, H100_SMS)


def test_plan_counts_the_shared_memory_of_the_source():
    """The tiles of `csrc/ss2d_scan_bwd.cu` at D <= 64, T = 64, N = 16, R = 2:
    bwd_main holds wx, x_dbl, x and dx, the sub-tile checkpoints of h, da and
    sigmoid(z), the warps' channel sums, dx_dbl, dy and du; bwd_local x_dbl,
    wx and x (then dy), and da."""
    J, JP, T = 34, 36, 64
    main = 2 * 64 * J + 2 * T * JP + 2 * T * 65 + 8 * 2 * 64 * 16 + 4 * T * 64 + 2 * 8 * 8 * J \
        + 2 * 8 * J + 4 * 8 * 64
    local = 2 * T * JP + max(2 * 64 * J + T * 65, 2 * T * 64) + 2 * T * 64
    plan = scan_cuda.k2_plan(8, 65536, 64, 16, 2, T, H100_SMS)
    assert (plan["smem_main"], plan["smem_local"]) == (4 * main, 4 * local) == (227_968, 85_248)


def test_wrapper_launches_with_the_plan(monkeypatch):
    """`ss2d_scan_pair_bwd` sizes its grid by `k2_plan` at its shapes and the
    card's SM count (a host without CUDA reaches that point through a fake
    library and device)."""
    seen = []

    class Planned(Exception):
        pass

    def plan(*args):
        seen.append(args)
        raise Planned

    monkeypatch.setattr(scan_cuda, "_library_bwd", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": H100_SMS}))
    monkeypatch.setattr(scan_cuda, "k2_plan", plan)
    before = scan_cuda.ss2d_scan_pair_bwd.launches
    with pytest.raises(Planned):
        scan_cuda.ss2d_scan_pair_bwd(*_fake_bwd_args(11, 2, 130, 64, 16, 2))
    assert seen == [(2, 130, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)]
    assert scan_cuda.ss2d_scan_pair_bwd.launches == before


def _occupancy_as_planned(plan):
    return {"threads": plan["threads"], "smem_local": plan["smem_local"],
            "smem_main": plan["smem_main"], "blocks_per_sm_local": plan["blocks_per_sm_local"],
            "blocks_per_sm_main": plan["blocks_per_sm_main"]}


def test_chip_smoke_geometry_reads_the_card_against_the_plan():
    plan = scan_cuda.k2_plan(8, 65536, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)
    geo = chip_smoke.k2_geometry(plan, _occupancy_as_planned(plan))
    assert geo == {"threads": 512, "smem_bytes": {"bwd_local": 85_248, "bwd_main": 227_968},
                   "blocks_per_sm": {"bwd_local": 2, "bwd_main": 1},
                   "warps_per_sm": {"bwd_local": 32, "bwd_main": 16},
                   "planned_warps_per_sm": {"bwd_local": 32, "bwd_main": 16}, "gx": 132}


@pytest.mark.parametrize("key,value,match", [
    ("blocks_per_sm_main", 0, "bwd_main: 0 blocks an SM, 1 planned"),
    ("blocks_per_sm_local", 1, "bwd_local: 1 blocks an SM, 2 planned"),
    ("smem_main", 200_000, "as k2_plan planned"),
])
def test_chip_smoke_geometry_fails_short_of_the_plan(key, value, match):
    """Registers the card reports can cut the residency below what shared
    memory and threads allow: the check fails rather than reporting it."""
    plan = scan_cuda.k2_plan(8, 65536, 64, 16, 2, scan_cuda.CHUNK, H100_SMS)
    occ = _occupancy_as_planned(plan)
    occ[key] = value
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.k2_geometry(plan, occ)
