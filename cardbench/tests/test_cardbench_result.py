"""The result line, and a run with its timed path broken underneath: each
fault a cell can have makes `correct` false."""

import json

import numpy as np
import pytest

from cardbench import run
from cardbench.tests.small import bench, small_root

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("workload", ["serve-uhd-f32", "train-uhdll-f32", "serve-uhd-fast"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(root, workload, trace):
    result = run.run_cell(bench(), workload, 2**31 + 5, 0.5, trace, "cpu", root=root)
    json.dumps(result)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert DEVICE_KEYS <= set(result["device"])
    for row in result["checks"].values():
        assert set(row) == {"value", "limit"} and row["value"] <= row["limit"]
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert "setup_s" in result["metrics"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "serve-uhd-f32", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_an_altered_answer_is_not_correct(root, monkeypatch):
    """An answer altered where it is produced: a block of the uint8 output
    moved by 8 levels."""
    from wavemamba_torch.utils import img_util

    real = img_util.batch2img

    def altered(batch, *a, **k):
        out = real(batch, *a, **k)
        out[:16, :16] = np.clip(out[:16, :16].astype(np.int16) + 8, 0, 255).astype(np.uint8)
        return out

    monkeypatch.setattr(img_util, "batch2img", altered)
    result = run.run_cell(bench(), "serve-uhd-f32", 9, 0.5, False, "cpu", root=root)
    assert result["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(root, monkeypatch):
    from wavemamba_torch.train import trainer

    def make_step(tcfg, mesh=None):
        def step(state, lq, gt):
            total, metrics = trainer.loss_fn(state.model, tcfg, trainer._to_float(lq),
                                             trainer._to_float(gt))
            return state, {k: v.detach() for k, v in metrics.items()}
        return step

    monkeypatch.setattr("wavemamba_torch.runner.make_train_step", make_step)
    result = run.run_cell(bench(), "train-uhdll-f32", 9, 0.5, False, "cpu", root=root)
    assert result["correct"] is False


def test_half_the_batch_left_out_is_not_correct(root, monkeypatch):
    from wavemamba_torch.train import trainer

    real = trainer.loss_fn

    def half(model, tcfg, lq, gt):
        keep = len(lq) // 2
        return real(model, tcfg, lq[:keep], gt[:keep])

    monkeypatch.setattr(trainer, "loss_fn", half)
    result = run.run_cell(bench(), "train-uhdll-f32", 9, 0.5, False, "cpu", root=root)
    assert result["correct"] is False
