"""Profiling and tracing hooks on `torch.profiler`. The counterpart of
`wavemamba_tpu/utils/profiler.py`: training and inference can write device
traces (Chrome trace JSON, viewable in Perfetto or `chrome://tracing`) with
named regions, and time steps against the device."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block (the host's ops and, where there is a card,
    its kernels) into `log_dir/trace_<pid>_<ns>.json`; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region that shows up in traces (a context manager)."""
    return torch.profiler.record_function(name)


def _synchronize(result):
    """Wait for the devices of every tensor in `result` (a tensor, or a
    list, tuple or dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """Wall time a step, fenced on the device: `step(result_fn)` calls
    `result_fn()` after the block and waits for the device of what it
    returns before it reads the clock."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self, result_fn=None):
        t0 = time.perf_counter()
        yield
        if result_fn is not None:
            _synchronize(result_fn())
        self.times.append(time.perf_counter() - t0)

    def summary(self):
        import numpy as np

        t = np.asarray(self.times[1:] or self.times)
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "min_s": float(t.min()), "n": len(self.times)}
