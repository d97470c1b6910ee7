"""On the card, at sizes a test run holds: every cell's control comes out
not correct against the cell's limits, and the program's run correct.
Run with `python -m pytest cardbench/tests -m card` on a machine with an
NVIDIA GPU; elsewhere these skip."""

import importlib

import pytest

from cardbench import check, run
from cardbench.tests.small import CARD_FRAMES, CARD_PAIRS, bench, small_root

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("card"), CARD_FRAMES, CARD_PAIRS, crop=512, batch=8)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [101, 2**31 + 102, 103])
def test_control_is_not_correct(cuda, card_root, workload, seed):
    _, config, traffic, _, _ = run.cell_spec(bench(), workload, card_root)
    loop = importlib.import_module(f"cardbench.loops.{traffic['loop']}")
    numbers = loop.control(run.Cell(workload, config, traffic, seed, 1.0, False, cuda, 0.0))
    ok, table = check.judge(numbers, check.load_limits(workload, card_root / "limits"))
    assert not ok, table


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(cuda, card_root, workload):
    result = run.run_cell(bench(), workload, 104, 2.0, False, str(cuda), root=card_root)
    assert result["correct"], result["checks"]
