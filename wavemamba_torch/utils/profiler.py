"""Profiling and tracing hooks on `torch.profiler`. The counterpart of
`wavemamba_tpu/utils/profiler.py`: training and inference can write device
traces (Chrome trace JSON, viewable in Perfetto or `chrome://tracing`) with
named regions.

The port's spans (`annotate`, names starting with `wm.`) live on the
profiler's own clock, in its memory, beside the kernels it records; whoever
holds the profiler (`trace`, or a benchmark's window) writes or reads them.
With no profiler recording a span costs one check."""

from __future__ import annotations

import contextlib
import os
import time

import torch

_OFF = contextlib.nullcontext()  # stateless, so one instance serves every unrecorded span


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block (the host's ops and spans and, where there is
    a card, its kernels) into `log_dir/trace_<pid>_<ns>.json`; yields the
    profiler. Input shapes are recorded, which also carries each span's
    `args` into the file."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities(), record_shapes=True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str, args: str | None = None):
    """A named span (a context manager) while a profiler records, else a
    shared no-op that calls nothing into the dispatcher. Spans nest on the
    calling thread: the enclosing one is the parent. `args` identifies the
    span (a request's file name); under `trace` it is written into the
    span's `args` as `id`."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if args is None:
        return torch.profiler.record_function(name)
    # record_function's own `args` never reaches an exported trace; the
    # profiler's keyword values do, where input shapes are recorded.
    return torch._C._profiler._RecordFunctionFast(name, (), {"id": args})
