"""Aggregate a Chrome trace of `torch.profiler` into a table of device time
by kernel. The counterpart of `scripts/trace_topops.py`, for the traces that
`wavemamba_torch.utils.profiler.trace` writes (`trace_<pid>_<ns>.json`).

Usage:
    python -m wavemamba_torch.scripts.trace_topops <log_dir or trace.json[.gz]> [n_iters] [--top N]

Reads the newest trace under a log dir, takes its device events (kernels,
memcpy and memset), groups them by a normalized kernel name (`void`, the
template arguments, the parameter list and a numeric suffix dropped, so
`void chunk_scan<16, 2, false, float, float>(...)` and its `true` replay are
one row, `chunk_scan`), and prints the device time per iteration of each
group, its calls per iteration and its share. A trace with no device event
(the profiler recorded none, or it was taken on the CPU) raises: there is no
device time to table. The script reads a file and touches no device.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(path):
    """(trace dict, its path): `path` itself, or the newest `trace_*.json[.gz]`
    (or `*.pt.trace.json[.gz]`) under the directory `path`."""
    if os.path.isdir(path):
        cands = [p for pattern in ("trace_*.json", "trace_*.json.gz", "*.pt.trace.json",
                                   "*.pt.trace.json.gz")
                 for p in glob.glob(os.path.join(path, "**", pattern), recursive=True)]
        if not cands:
            raise FileNotFoundError(f"no trace_*.json under {path}")
        path = max(cands, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f), path


def device_op_events(trace):
    """The complete events ('X') of the device: kernels, copies and sets."""
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            yield e


_TEMPLATE = re.compile(r"<[^<>]*>")
_SUFFIX = re.compile(r"[.\-_]?\d+$")


def normalize(name):
    """`void ns::kernel<args>(params)` -> `ns::kernel` (an anonymous namespace
    dropped); `fusion_12` -> `fusion`; `Memcpy HtoD (Pageable -> Device)` ->
    `Memcpy HtoD`."""
    name = name.replace("(anonymous namespace)::", "")
    while True:
        stripped = _TEMPLATE.sub("", name)
        if stripped == name:
            break
        name = stripped
    name = name.split("(")[0].strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return _SUFFIX.sub("", name.strip())


def main(path, n_iters=1, top=25):
    """Print the table; returns ({group: device ms over the trace}, total ms,
    {group: calls over the trace})."""
    trace, src = load_trace(path)
    per_op = collections.Counter()
    per_op_count = collections.Counter()
    total = 0.0
    for e in device_op_events(trace):
        dur = e.get("dur", 0) / 1e3  # us -> ms
        key = normalize(e["name"])
        per_op[key] += dur
        per_op_count[key] += 1
        total += dur
    if not per_op_count:
        raise ValueError(f"{src} holds no device event (kernel, memcpy or memset): the profiler "
                         "recorded none, or the trace was taken on the CPU")
    print(f"# {src}")
    print(f"# total device op time: {total:.1f} ms "
          f"({total / n_iters:.1f} ms/iter over {n_iters} iters)\n")
    print(f"{'op':<40} {'ms/iter':>9} {'calls':>7} {'%':>6}")
    for key, ms in per_op.most_common(top or None):
        print(f"{key:<40} {ms / n_iters:>9.2f} {per_op_count[key] // n_iters:>7} "
              f"{100 * ms / total:>5.1f}%")
    return per_op, total, per_op_count


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="a log dir or a trace file")
    ap.add_argument("n_iters", nargs="?", type=int, default=1)
    ap.add_argument("--top", type=int, default=25, help="rows to print; 0 prints every one")
    args = ap.parse_args(argv)
    main(args.path, args.n_iters, args.top)


if __name__ == "__main__":
    cli()
