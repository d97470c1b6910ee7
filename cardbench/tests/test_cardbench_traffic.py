"""The generators repeat by seed, and a new mix is a file alone."""

import json

import numpy as np
import pytest
import torch

from cardbench import run, traffic_gen
from cardbench.tests.small import SMALL_FRAMES, SMALL_PAIRS, bench, small_root

FRAMES = {**run.load_json(run.HERE / "traffic" / "uhd-frames-closed1.json"), **SMALL_FRAMES}
PAIRS = {**run.load_json(run.HERE / "traffic" / "uhdll-crops-4k64.json"), **SMALL_PAIRS}
BIG_SEED = 2**31 + 977


def test_frames_repeat_by_seed():
    a, b = (traffic_gen.frames(FRAMES, BIG_SEED, "cpu") for _ in range(2))
    c = traffic_gen.frames(FRAMES, BIG_SEED + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert a[0].dtype == np.uint8 and a[0].shape == (48, 64, 3)


def test_pairs_repeat_by_seed():
    (lq, gt), (lq2, gt2) = (traffic_gen.pairs(PAIRS, BIG_SEED, "cpu") for _ in range(2))
    assert np.array_equal(lq, lq2) and np.array_equal(gt, gt2)
    assert lq.shape == gt.shape == (6, 48, 64, 3)
    assert lq.mean() < gt.mean()  # the input is the dark shot of the scene


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, 2**40 + 3])
def test_order_and_checked_repeat_by_seed(seed):
    order = traffic_gen.order(FRAMES, seed, 10)
    assert np.array_equal(order, traffic_gen.order(FRAMES, seed, 10))
    assert sorted(order[:3].tolist()) == [0, 1, 2]  # whole cycles through the pool
    assert traffic_gen.checked(seed, 24, 3) == traffic_gen.checked(seed, 24, 3)


def test_weights_repeat_by_seed():
    from cardbench.reference.init import make_state_dict
    from cardbench.reference.wavemamba import WaveMamba

    model = WaveMamba()
    a, b = (make_state_dict(model, 5, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    model.load_state_dict(a, strict=True)


def test_a_new_mix_is_a_file(tmp_path):
    """A cell added by a new traffic file, a limits file and an entry of
    BENCHMARK.json runs without any edit to the harness."""
    root = small_root(tmp_path)
    mix = json.loads((root / "traffic" / "uhd-frames-closed1.json").read_text())
    mix.update(height=40, width=72, pool=2)
    (root / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (root / "limits" / "serve-throwaway.json").write_text(
        (root / "limits" / "serve-uhd-f32.json").read_text())
    b = bench()
    b["workloads"].append({"name": "serve-throwaway", "config": "wavemamba-uhdll-f32",
                           "traffic": "throwaway", "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "serve-uhd-f32" in m.get("workloads", []):
            m["workloads"].append("serve-throwaway")
    result = run.run_cell(b, "serve-throwaway", 3, 0.5, False, "cpu", root=root)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"serve_images_per_s", "serve_latency_p90_ms", "setup_s"}
