"""The comparison that decides `correct`: numbers read from the program's
answers against the reference's, each held to a limit of its own.

A cell's limits are `limits/<workload>.json`: for each number its `limit`
and the readings it was set from (`lower`: the largest that sound runs of
the program gave, `upper`: the smallest that the control gave). A number at
or under its limit passes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LIMITS = Path(__file__).resolve().parent / "limits"


def load_limits(workload: str, directory: Path = LIMITS) -> dict:
    return json.loads((directory / f"{workload}.json").read_text())


def compare_u8(prog: np.ndarray, ref: np.ndarray) -> dict:
    """Two uint8 answers of one request: the share of their values that
    differ, the widest difference and the root mean square difference, in
    levels."""
    if prog.shape != ref.shape:
        raise ValueError(f"answer of shape {prog.shape}, reference {ref.shape}")
    diff = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return {"share_off": float(np.count_nonzero(diff)) / diff.size,
            "max_levels": int(diff.max()),
            "rms_levels": float(np.sqrt(np.mean(np.square(diff, dtype=np.float64))))}


def widest(readings: list[dict]) -> dict:
    """Each number's worst (largest) value over several requests."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the limits name within its limit, {name: {'value',
    'limit'}}). A named number the run did not read fails."""
    table = {n: {"value": numbers.get(n), "limit": lim["limit"]}
             for n, lim in sorted(limits.items())}
    ok = all(row["value"] is not None and row["value"] <= row["limit"]
             for row in table.values())
    return ok, table


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: the gap between two norms of the leaf, over the reference's
    norm of that leaf or of the median leaf, whichever is larger}."""
    median = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves}


def train_gaps(prog: dict, ref: dict) -> dict:
    """The first steps of a training run against the reference's.

    Each side: `losses` (a step's loss each), `grad` ({leaf: norm of the
    first step's gradient}) and `change` ({leaf: norm of the parameters'
    change over the steps}). Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out
    of the leaf gaps. Each gap is read by the worst leaf and by the median
    leaf, and the loss gap over all steps and at the first."""
    median = float(np.median(list(ref["grad"].values())))
    leaves = [k for k, v in ref["grad"].items() if v >= 1e-3 * median]
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad, change = (leaf_gaps(prog[k], ref[k], leaves) for k in ("grad", "change"))
    return {"loss_gap": max(steps), "first_loss_gap": steps[0],
            "grad_gap": max(grad.values()), "median_grad_gap": float(np.median(list(grad.values()))),
            "change_gap": max(change.values()),
            "median_change_gap": float(np.median(list(change.values())))}
