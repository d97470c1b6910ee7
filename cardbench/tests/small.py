"""A copy of the benchmark's data files with every size cut to what a test
can run: on the CPU frames and pairs of 48x64, crops of 32, batch 2; on the
card (`CARD_*`) frames of 544x960 and pairs of 1024x1024 at the cells' own
crop and batch."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from cardbench import run

SMALL_FRAMES = {"height": 48, "width": 64, "pool": 3, "scene_grid": [3, 4],
                "detail_grid": [8, 12], "warmup_requests": 1, "trace_requests": 2,
                "kept_requests": 3, "checked_requests": 2}
SMALL_PAIRS = {"pairs": 6, "make_batch": 3, "height": 48, "width": 64, "scene_grid": [3, 4],
               "detail_grid": [8, 12], "checked_steps": 3, "trace_steps": 2}


def small_root(tmp: Path, frames: dict = SMALL_FRAMES, pairs: dict = SMALL_PAIRS,
               crop: int = 32, batch: int = 2) -> Path:
    """`tmp/cardbench`: the data files and readers, sizes cut."""
    root = tmp / "cardbench"
    for sub in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(run.HERE / sub, root / sub)
    for path in (root / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(frames if mix["loop"] == "serve" else pairs)
        path.write_text(json.dumps(mix))
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if "train" in cfg:
            cfg["train"]["dataset"].update(gt_size=crop, batch_size_per_gpu=batch)
        path.write_text(json.dumps(cfg))
    return root


def bench() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


CARD_FRAMES = {"height": 544, "width": 960, "pool": 4, "warmup_requests": 1,
               "trace_requests": 2, "kept_requests": 4, "checked_requests": 2}
CARD_PAIRS = {"pairs": 16, "make_batch": 8, "height": 1024, "width": 1024,
              "checked_steps": 3, "trace_steps": 2}
