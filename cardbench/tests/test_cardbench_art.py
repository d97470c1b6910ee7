"""The two cells that serve ART and 1080p frames, run on the CPU at the
test sizes of `small.py`; ART's FLOP count and attention shapes against
counts by hand and torch's FLOP counter; the new readers on hand-built
traces. The serve_art mix is cut to the test frames here: `small.py` cuts
the mixes of the `serve` loop alone."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench import flops_art, run
from cardbench.reference.art import ART
from cardbench.roofline_art import attention_bound
from cardbench.tests.small import SMALL_FRAMES, bench, small_root
from cardbench.trace import Trace

NETWORK = {"type": "ART", "dim": 48, "n_blocks": 8, "num_heads": 6, "window_size": 8,
           "interval": 16, "mlp_ratio": 2.0, "upscaling_factor": 4}
CELLS = ["serve-uhd-art-f32", "serve-1080p-fast"]
MS = 1_000_000  # ns


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("small"))
    path = root / "traffic" / "uhd-frames-closed1-net.json"
    mix = json.loads(path.read_text())
    mix.update(SMALL_FRAMES)
    path.write_text(json.dumps(mix))
    return root


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_new_cell_runs_correct_on_the_cpu(root, workload, trace):
    result = run.run_cell(bench(), workload, 2**31 + 41, 0.5, trace, "cpu", root=root)
    json.dumps(result)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    listed = {m["name"] for m in bench()["per_layer"] + bench()["end_to_end"]
              if workload in m.get("workloads", [workload])}
    if trace:
        art = {"art_pos_bias_ms.serve", "art_attn_share.serve", "art_attn_roofline.serve"}
        assert (art <= listed) == (workload == CELLS[0]) and not art & listed - art
        assert result["metrics"]["forward_host_ms.serve"]["value"] > 0
        if workload == CELLS[0]:  # no device operation on the CPU: the trace readers read nothing
            assert result["metrics"]["art_pos_bias_ms.serve"]["value"] > 0
            assert "art_attn_roofline.serve" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"serve_images_per_s", "serve_latency_p90_ms", "setup_s"}


def test_the_art_cell_fails_at_once_without_load_model(root, monkeypatch):
    """A program without `inference.load_model` (an older one) cannot run
    the cell: the run raises at once."""
    from wavemamba_torch import inference

    monkeypatch.delattr(inference, "load_model")
    with pytest.raises(ImportError):
        run.run_cell(bench(), CELLS[0], 1, 0.5, False, "cpu", root=root)


def test_forward_flops_by_hand_at_a_small_size():
    """dim 8 (width 32, 2 heads, pos-bias width 2), 1 block, window 4,
    interval 4, mlp 2, on 32x48: a 8x12 token grid, 96 tokens, no pad; 6
    windows of 16 tokens, 16 sparse groups of 2x3 = 6 tokens."""
    g = {**NETWORK, "dim": 8, "n_blocks": 1, "num_heads": 2, "window_size": 4, "interval": 4}
    t, c = 96, 32
    conv = 2 * 32 * 48 * 2 * 3 * 9 + 2 * t * 48 * c * 9 + 2 * t * 2 * c * c
    pos = lambda m: 2 * m * (2 * 2 + 2 * 2 * 2 + 2 * 2)  # noqa: E731
    linear = 2 * (2 * t * c * 3 * c + 2 * t * c * c) + pos(7 * 7) + pos(3 * 5) + 2 * 2 * t * c * 64
    attention = 2 * 2 * t * 16 * c + 2 * 2 * t * 6 * c
    assert flops_art.forward_flops(g, 1, 32, 48) == {"conv": conv, "linear": linear,
                                                      "attention": attention}
    assert flops_art.attention_calls(g, 2, 32, 48) == [(12, 2, 16, 16, 1, 49), (32, 2, 6, 16, 1, 15)]


@pytest.mark.parametrize("h, w", [(64, 64), (72, 100)])
def test_forward_flops_match_flop_counter(h, w):
    """The reference's convolutions, linear layers and products as torch's
    counter sees them, at the published widths; 72x100 pads both
    attentions (an 18x25 grid)."""
    g = {**NETWORK, "n_blocks": 2}
    model = ART(**{k: v for k, v in g.items() if k != "type"}).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.rand(1, 3, h, w))
    seen = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    mine = flops_art.forward_flops(g, 1, h, w)
    assert seen.pop("aten.convolution") == mine["conv"]
    assert sum(seen.values()) == mine["linear"] + mine["attention"]
    classes = [c[4] for c in flops_art.attention_calls(g, 1, h, w)]
    assert classes == ([1, 1] if h == 64 else [4, 4]) * 2


def test_the_uhd_request_flops_and_the_sparse_share():
    """11.2 TFLOP a 2176x3840 request, the sparse attention 59% of it, and
    each sparse call bound by the products at 495 / 3 TFLOP/s."""
    f = flops_art.forward_flops(NETWORK, 1, 2176, 3840)
    total = sum(f.values())
    assert 11.1e12 < total < 11.3e12
    calls = flops_art.attention_calls(NETWORK, 1, 2176, 3840)
    assert calls[1] == (256, 6, 2040, 32, 1, 67 * 119)
    sparse = 8 * 4 * 256 * 6 * 2040**2 * 32
    assert 0.58 < sparse / total < 0.60
    seconds, unit = attention_bound(*calls[1])
    assert unit == "tensor" and seconds == pytest.approx(4 * 256 * 6 * 2040**2 * 32 / 165e12)


def _ctx(device_ops, host_ops=(), calls=2, requests=2):
    shapes = [(256, 6, 2040, 32, 1, 8003)] * 2
    return {"kind": "serve", "requests": requests, "attn_calls": calls, "attn_shapes": shapes,
            "trace": Trace((0, 100 * MS), list(device_ops), list(host_ops))}


def test_the_attention_readers_on_a_hand_built_trace():
    ops = [("fmha_cutlassF_f32_aligned_64x64_rf_sm80", 0, 20 * MS),
           ("void PyTorchMemEffAttention::AttentionKernel<float>", 30 * MS, 50 * MS),
           ("sgemm", 50 * MS, 90 * MS)]
    roof, share = run.reader("art_attn_roofline.serve"), run.reader("art_attn_share.serve")
    least = 2 * attention_bound(256, 6, 2040, 32, 1, 8003)[0]
    assert roof(_ctx(ops)) == pytest.approx(100 * least * 2 / 0.040)
    assert share(_ctx(ops)) == pytest.approx(100 * 40 / 80)  # busy: [0, 20) and [30, 90)
    assert roof(_ctx(ops, calls=3)) is None  # the profile dropped a record
    assert roof(_ctx(ops, calls=0)) is None  # a program without the counter
    assert share(_ctx(ops[2:])) is None


def test_the_pos_bias_reader_sums_its_span_over_the_requests():
    read = run.reader("art_pos_bias_ms.serve")
    host = [("wm.art.pos_bias", 0, 3 * MS), ("wm.art.sparse", 0, 9 * MS),
            ("wm.art.pos_bias", 5 * MS, 10 * MS)]
    assert read(_ctx([], host)) == pytest.approx(4.0)
    assert read(_ctx([], host[1:2])) is None
