"""Reading a `torch.profiler` profile: the device's operations as intervals,
the traced window, busy time as the union of the intervals (overlapping
kernels count once), idle gaps and what the host was doing in each.

The window is the benchmark's own span `WINDOW`, recorded with
`record_function` around the traced work; every interval is clipped to it.
Device operations are kernels, copies and fills; the profiler's mirrors of
host annotations on the device's timeline are not operations.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

WINDOW = "cardbench.window"


@dataclass
class Trace:
    window: tuple[int, int]  # ns
    device_ops: list[tuple[str, int, int]] = field(default_factory=list)  # (name, start, end)
    host_ops: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.device_ops)) * 1e-9

    def device_s(self, match) -> float:
        """Seconds of the device operations whose name `match`es."""
        return sum(e - s for name, s, e in self.device_ops if match(name)) * 1e-9


@contextlib.contextmanager
def profiled(device_type: str):
    """Profile the body; yields a list that holds the `Trace` afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == "cuda" else [])
    out = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
    out.append(read(prof.profiler.kineto_results.events()))


def read(events) -> Trace:
    """The `Trace` of a profile's kineto events."""
    from torch.autograd import DeviceType

    window, dev, host = None, [], []
    for ev in events:
        start = ev.start_ns()
        span = (ev.name(), start, start + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():  # the device's mirror of a host span
                dev.append(span)
        elif ev.name() == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    clip = lambda ops: [(n, max(s, window[0]), min(e, window[1]))  # noqa: E731
                        for n, s, e in ops if e > window[0] and s < window[1]]
    return Trace(window, sorted(clip(dev), key=lambda t: t[1]), clip(host))


def union(ops) -> list[tuple[int, int]]:
    """Merged [start, end) intervals of `ops` ((name, start, end), sorted by start)."""
    merged: list[list[int]] = []
    for _, s, e in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def gaps(trace: Trace) -> list[tuple[int, int]]:
    """The window's stretches with no device operation running."""
    out, at = [], trace.window[0]
    for s, e in union(trace.device_ops):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if trace.window[1] > at:
        out.append((at, trace.window[1]))
    return out


def host_op_at(trace: Trace, t: int) -> str:
    """The innermost host operation or span open at time `t`."""
    open_ = [(e - s, n) for n, s, e in trace.host_ops if s <= t < e and n != WINDOW]
    return min(open_)[1] if open_ else "(no host operation)"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps,
    each with the host operation open at its middle."""
    by_name: dict[str, float] = {}
    for name, s, e in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]
    idle = [[host_op_at(trace, (s + e) // 2), (e - s) * 1e-9] for s, e in longest]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
