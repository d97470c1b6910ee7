"""The readers of the program's spans (`layer_metrics/*_ms.*`,
`idle_unspanned_share.*`): their arithmetic on hand-built traces, nothing
where there is nothing to read, and a number from a traced CPU run of each
cell."""

import pytest

from cardbench import run
from cardbench.tests.small import bench, small_root
from cardbench.trace import Trace

SPANS = {  # metric: (the program's span, loop)
    "img2batch_ms.serve": ("wm.img2batch", "serve"),
    "pad_ms.serve": ("wm.enhance.pad", "serve"),
    "h2d_ms.serve": ("wm.enhance.h2d", "serve"),
    "forward_host_ms.serve": ("wm.enhance.forward", "serve"),
    "d2h_ms.serve": ("wm.enhance.d2h", "serve"),
    "batch2img_ms.serve": ("wm.batch2img", "serve"),
    "forward_host_ms.train": ("wm.step.forward", "train"),
    "backward_host_ms.train": ("wm.step.backward", "train"),
    "update_host_ms.train": ("wm.step.update", "train"),
    "batch_gather_ms.train": ("wm.data.batch", "train"),
}
COUNT = {"serve": "requests", "train": "steps"}
MS = 1_000_000  # ns


def _ctx(kind, host_ops, device_ops=(), n=2, window=(0, 100 * MS)):
    return {"kind": kind, COUNT[kind]: n,
            "trace": Trace(window, list(device_ops), list(host_ops))}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_span_reader_sums_its_span_over_the_requests_or_steps(metric):
    span, kind = SPANS[metric]
    read = run.reader(metric)
    ops = [(span, 0, 3 * MS), ("wm.other", 0, 50 * MS), (span, 10 * MS, 15 * MS),
           ("aten::add", 11 * MS, 12 * MS)]
    assert read(_ctx(kind, ops)) == pytest.approx(4.0)  # (3 + 5) ms over 2
    assert read(_ctx(kind, ops[1:2])) is None  # the parent's program: no such span
    assert read(_ctx(kind, ops, n=0)) is None
    other = "train" if kind == "serve" else "serve"
    assert read(_ctx(other, ops)) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_idle_unspanned_share_is_the_idle_time_outside_the_wm_spans(kind):
    read = run.reader(f"idle_unspanned_share.{kind}")
    dev = [("k", 100, 200), ("k", 400, 500), ("k", 450, 480)]  # idle: [0,100) [200,400) [500,1000)
    host = [("wm.a", 50, 300), ("wm.b", 250, 450), ("wm.c", 60, 70),  # union [50, 450)
            ("aten::add", 600, 900), ("cardbench.batch2img", 500, 1000)]  # not the program's spans
    assert read(_ctx(kind, host, dev, window=(0, 1000))) == pytest.approx(100.0 * 550 / 800)
    assert read(_ctx(kind, host + [("wm.d", 0, 1000)], dev, window=(0, 1000))) == 0.0
    assert read(_ctx(kind, host, [("k", 0, 1000)], window=(0, 1000))) == 0.0  # never idle
    assert read(_ctx(kind, host[3:], dev, window=(0, 1000))) is None  # no wm.* span
    assert read(_ctx(kind, host, (), window=(0, 1000))) is None  # no device operation
    other = "train" if kind == "serve" else "serve"
    assert read(_ctx(other, host, dev, window=(0, 1000))) is None


def test_every_span_reader_is_listed_for_the_cells_of_its_loop():
    listed = {m["name"]: m for m in bench()["per_layer"]}
    for metric, (_, kind) in SPANS.items():
        assert listed[metric]["source"] == "program_span"
        assert all(w.startswith(kind) for w in listed[metric]["workloads"])
    for kind in ("serve", "train"):
        assert listed[f"idle_unspanned_share.{kind}"]["source"] == "device_trace"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("workload", ["serve-uhd-f32", "train-uhdll-f32", "serve-uhd-fast"])
def test_a_traced_cpu_run_reads_every_span_metric_of_its_cell(root, workload):
    result = run.run_cell(bench(), workload, 2**31 + 17, 0.5, True, "cpu", root=root)
    assert result["correct"] is True
    want = {m["name"] for m in bench()["per_layer"]
            if m["name"] in SPANS and workload in m["workloads"]}
    assert want and want <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0 for m in want)
