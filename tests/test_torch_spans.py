"""The port's spans (`utils/profiler.annotate`) on the CPU: free while no
profiler records, and under `torch.profiler` one span a part at the layer
boundaries of the request path (`utils/img_util.py`, `inference.enhance`,
the CLI's `--trace`), the train step (`train/trainer.py`) and the device
cache's loader (`data/device_cache.py`), nested and ordered as the work
runs."""

import contextlib
import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wavemamba_torch import inference as tinf
from wavemamba_torch.data.device_cache import DeviceCachedLoader
from wavemamba_torch.models import init_network
from wavemamba_torch.models.buckets import BucketLadder
from wavemamba_torch.models.wavemamba import WaveMambaConfig
from wavemamba_torch.train import trainer
from wavemamba_torch.utils import img_util
from wavemamba_torch.utils import profiler as tprof

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SIZE_FLAGS = ["--wf", "8", "--n_l_blocks", "1", "1", "1", "--n_h_blocks", "1", "1", "1"]
CFG = WaveMambaConfig(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
ENHANCE = ["wm.enhance.pad", "wm.enhance.h2d", "wm.enhance.forward", "wm.enhance.d2h"]
STEP = ["wm.step.forward", "wm.step.backward", "wm.step.update"]
OUTER = "test.call"


def _model(train=False):
    opt = {"type": "WaveMamba", **dataclasses.asdict(CFG)}
    return init_network(opt, torch.Generator().manual_seed(0), device="cpu", train=train)


def _frame(h=40, w=56, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 60).astype(np.uint8)


def _traced(fn):
    """fn() under the profiler, inside an `OUTER` span -> (fn's result,
    [(name, start_us, end_us)] of the `wm.*` and `test.*` spans in start
    order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(("wm.", "test."))]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(spans, names):
    """The spans named in `names`, each checked to lie within `OUTER`."""
    (_, s0, e0), = [s for s in spans if s[0] == OUTER]
    got = [s for s in spans if s[0] in names]
    assert all(s0 <= s <= e <= e0 for _, s, e in got), spans
    return got


def _in_order(got):
    """Each span ends before the next one starts."""
    return all(a[2] <= b[1] for a, b in zip(got, got[1:]))


def _loader(batch=2, n=4):
    rs = np.random.RandomState(1)
    lq, gt = ((rs.rand(n, 40, 48, 3) * 255).astype(np.uint8) for _ in range(2))
    paths = [{"lq_path": f"{i}", "gt_path": f"{i}"} for i in range(n)]
    return DeviceCachedLoader.from_arrays(
        lq, gt, paths, {"phase": "train", "gt_size": 16, "scale": 1, "geometric_augs": True},
        batch, seed=3, device="cpu")


def _step_twice():
    model = _model(train=True)
    tcfg = trainer.TrainConfig(ema_decay=0.9, grad_clip=1.0)
    state = trainer.create_train_state(model, tcfg)
    step = trainer.make_train_step(tcfg)
    rs = np.random.RandomState(2)
    lq, gt = (torch.from_numpy((rs.rand(1, 32, 32, 3) * 255).astype(np.uint8)) for _ in range(2))
    for _ in range(2):
        state, _ = step(state, lq, gt)
    return state


def test_annotate_calls_nothing_but_the_enabled_check_when_off(monkeypatch):
    """With no profiler recording, `annotate` returns one shared no-op and
    opens no `record_function`, on its own and along the request path, the
    train step and the loader."""
    real = torch.autograd.profiler.record_function

    def refuse(name, *a, **k):  # torch's own spans (AdamW's) pass through
        assert not name.startswith("wm."), f"{name} was entered with no profiler recording"
        return real(name, *a, **k)

    checks = []
    real_enabled = torch.autograd._profiler_enabled
    monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                        lambda: checks.append(1) or real_enabled())
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)

    off = tprof.annotate("wm.a")
    assert off is tprof.annotate("wm.b", args="x.png")
    assert isinstance(off, contextlib.nullcontext) and len(checks) == 2
    with off, off:  # shared and stateless: nests with itself
        pass

    model = _model()
    out = img_util.batch2img(tinf.enhance(model, img_util.img2batch(_frame()), BucketLadder()))
    assert out.shape == (40, 56, 3)
    assert tinf.enhance(model, img_util.img2batch(_frame()), None, tile=16).shape == (1, 40, 56, 3)
    _step_twice()
    assert len(list(_loader())) == 2
    assert len(checks) > 2


def test_enhance_opens_pad_h2d_forward_d2h_once_each_in_order():
    model = _model()
    batch = img_util.img2batch(_frame())
    out, spans = _traced(lambda: tinf.enhance(model, batch, BucketLadder()))
    assert out.shape == (1, 40, 56, 3)
    got = _inside(spans, ENHANCE)
    assert [s[0] for s in got] == ENHANCE and _in_order(got)


@pytest.mark.parametrize("name", ["img2batch", "batch2img"])
def test_image_conversions_open_their_span(name):
    arg = _frame() if name == "img2batch" else np.random.RandomState(0).rand(1, 8, 8, 3)
    _, spans = _traced(lambda: getattr(img_util, name)(arg))
    assert [s[0] for s in _inside(spans, {f"wm.{name}"})] == [f"wm.{name}"]


@pytest.mark.parametrize("h, w, calls", [(40, 56, 2), (24, 24, 1)])
def test_tiled_route_opens_one_triple_a_model_call(h, w, calls):
    """The tiled route runs its tiles 8 to a model call (`tiled_apply`):
    12 tiles of 16 (40x56) take two calls, 4 (24x24) one. Each call is one
    h2d / forward / d2h triple, and no pad span (the canvas is the tiles')."""
    model = _model()
    batch = img_util.img2batch(_frame(h, w))
    out, spans = _traced(lambda: tinf.enhance(model, batch, None, tile=16))
    assert out.shape == (1, h, w, 3)
    got = _inside(spans, ENHANCE)
    assert [s[0] for s in got] == ENHANCE[1:] * calls and _in_order(got)


def test_train_step_opens_forward_backward_update_once_a_step():
    _, spans = _traced(_step_twice)
    got = _inside(spans, STEP)
    assert [s[0] for s in got] == STEP * 2 and _in_order(got)


def test_loader_closes_its_batch_span_before_the_consumer_works():
    loader = _loader()

    def consume():
        n = 0
        for b in loader:
            with record_function("test.consumer"):
                n += int(b["lq"].shape[0])
        return n

    n, spans = _traced(consume)
    assert n == 4
    got = _inside(spans, {"wm.data.batch", "test.consumer"})
    assert [s[0] for s in got] == ["wm.data.batch", "test.consumer"] * 2 and _in_order(got)


def test_inference_cli_trace_holds_each_request_with_its_spans(tmp_path):
    """`--trace DIR` writes one Chrome trace: a `wm.request` span a file,
    its name in `args`, over the image's conversions and `enhance`'s four
    spans."""
    pth = str(tmp_path / "w.pth")
    torch.save({"params": _model().state_dict()}, pth)
    os.makedirs(tmp_path / "in")
    for i, name in enumerate(["a.png", "b.png"]):
        cv2.imwrite(str(tmp_path / "in" / name), _frame(seed=i))
    tinf.main(["-i", str(tmp_path / "in"), "-w", pth, "-o", str(tmp_path / "out"),
               "--device", "cpu", "--trace", str(tmp_path / "trace")] + SIZE_FLAGS)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and sorted(os.listdir(tmp_path / "out")) == ["a.png", "b.png"]
    with open(tmp_path / "trace" / files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    requests = sorted((e for e in events if e["name"] == "wm.request"), key=lambda e: e["ts"])
    assert [e["args"]["id"] for e in requests] == ["a.png", "b.png"]
    for req in requests:
        inner = sorted((e for e in events if e["name"].startswith("wm.") and e is not req
                        and req["ts"] <= e["ts"] and e["ts"] + e["dur"] <= req["ts"] + req["dur"]),
                       key=lambda e: e["ts"])
        assert [e["name"] for e in inner] == ["wm.img2batch", *ENHANCE, "wm.batch2img"]
