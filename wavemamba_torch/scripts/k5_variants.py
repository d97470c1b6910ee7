"""K5's sources side by side on the card.

`python -m wavemamba_torch.scripts.k5_variants [--source PATH ...] [--turns N] [--out FILE]`
builds each K5 source (by default the port's own, `csrc/ss2d_scan_ssd.cu`; a
variant or another checkout's source, unpacked with `git archive`, is built
with the headers beside it), holds each at level 3 of a 1080p forward against
K5's plain version (`chip_smoke.py:K5_ATOL`, y and carries, the same bits
twice), then times each at the three levels of a 1080p forward (B = 1, D =
64, N = 16, R = 2, sub 8, float32 streams) in turns on the same inputs: CUDA
events (median of 20), and on the first turn the device time of each of its
three kernels (torch.profiler) and the SM clock and power under level 1's
load. Per source also its registers and spills (`-Xptxas -v`), the blocks an
SM the card's occupancy query reports (where the source exports one), and the
issued instructions a MUFU of each pass's hot loop (SASS). One JSON line per
row, each with the card's name and power limit, also written to `--out`. A
source may have either C interface K5 has had: `ss2d_scan_pair_ssd` (stream
pairs, the x_dbl scratch, `scan_cuda.k5_plan`'s shared memory) or the float32
`ss2d_scan_pair_ssd_f32` of its first design. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from wavemamba_torch.ops import scan_cuda
from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
from wavemamba_torch.scripts.gpu_probe import sass_loop
from wavemamba_torch.utils import cxx

ROOT = Path(__file__).resolve().parents[2]
SUB = 8
# The mangled template arguments of the <16, 2> passes of each interface:
# <..., pass, float, float> today, <..., pass> in the first design.
TEMPLATES = {False: {"pass1": "ILi16ELi2ELb0EffE", "replay": "ILi16ELi2ELb1EffE"},
             True: {"pass1": "ILi16ELi2ELb0EE", "replay": "ILi16ELi2ELb1EE"}}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ptxas_resources(log, templates):
    """{pass1, replay, prefix: (registers, spill store bytes, spill load
    bytes)} of the <16, 2> instantiations named by `templates` and of
    chunk_prefix, from a `-Xptxas -v` report."""
    out, lines = {}, log.splitlines()
    keys = {**{f"chunk_scan_ssd{tag}": name for name, tag in templates.items()}, "chunk_prefix": "prefix"}
    for i, ln in enumerate(lines):
        name = next((n for key, n in keys.items() if key in ln), None)
        if "Compiling entry function" in ln and name:
            text = " ".join(lines[i + 1:i + 4])
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            out[name] = (int(re.search(r"Used (\d+) registers", text).group(1)),
                         int(spills.group(1)), int(spills.group(2)))
    return out


class Variant:
    """One built K5 source, bound through whichever C interface it has."""

    def __init__(self, source: Path):
        self.source = source
        self.library = cxx.build(source)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.first = b"ss2d_scan_pair_ssd_f32(" in source.read_bytes()
        table = ({"ss2d_scan_pair_ssd_f32": ([p] * 9 + [i] * 7 + [p], i)} if self.first else
                 {"ss2d_scan_pair_ssd": ([p] * 10 + [i] * 10 + [p], i),
                  "ss2d_scan_ssd_occupancy": ([i] * 6 + [ctypes.POINTER(i)], i)})
        self.lib = cxx.load(source, table, "K5", prefix="ss2d_scan_ssd")

    def call(self, args):
        """A callable that runs the kernel on `args` into outputs it keeps,
        and those outputs (y, state, sumda)."""
        x = args[0]
        b, length, d = x.shape
        nc = -(-length // scan_cuda.CHUNK)
        outs = [torch.empty((b, 2, length, d), device=x.device),
                torch.empty((b, 2, nc, 16, d), device=x.device),
                torch.empty((b, 2, nc, d), device=x.device)]
        shape = (b, length, d, 16, 2, scan_cuda.CHUNK, SUB)
        if self.first:
            entry, tail = "ss2d_scan_pair_ssd_f32", ()
            bufs = [*args, *outs]
        else:
            plan = scan_cuda.k5_plan(b, length, d, 16, 2, scan_cuda.CHUNK, SUB,
                                     cxx.sm_count(x.device.index))
            entry, tail = "ss2d_scan_pair_ssd", (plan["smem_scan"], 0, 0)
            bufs = [*args, *outs, torch.empty(plan["xdbl_shape"], device=x.device)]

        def run():  # `bufs` keeps every buffer the kernel writes alive
            cxx.launch(self.lib, entry, x.device, *(t.data_ptr() for t in bufs), *shape, *tail)
        return run, outs

    def resources(self):
        templates = TEMPLATES[self.first]
        row = {"registers_spills": ptxas_resources(self.library.with_suffix(".log").read_text(), templates),
               "occupancy": None,
               "sass_loop": {name: sass_loop("chunk_scan_ssd", self.library, "MUFU", tag)["per_op"]
                             for name, tag in templates.items()}}
        if not self.first:
            out = (ctypes.c_int * 6)()
            cxx.call(self.lib, "ss2d_scan_ssd_occupancy", 16, 2, 64, scan_cuda.CHUNK, 0, 0, out)
            row["occupancy"] = dict(zip(("threads", "smem_scan", "blocks_per_sm_pass1",
                                         "blocks_per_sm_replay", "prefix_threads",
                                         "blocks_per_sm_prefix"), out))
        return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", type=Path,
                        help="a K5 .cu file (repeatable); default: the port's own")
    parser.add_argument("--turns", type=int, default=2, help="timings of each source, in turn")
    parser.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("k5_variants: torch.cuda.is_available() is False; this script times the card")
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = args.out.open("w") if args.out else None

    def emit(row):
        line = json.dumps({**row, "device": smi})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    sources = [s.resolve() for s in args.source or [scan_cuda.SOURCE_K5]]
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, started together
        list(pool.map(cxx.build, sources))
    variants = [Variant(s) for s in sources]
    rs = np.random.RandomState(5)
    inputs = [cs.pair_inputs(rs, 1, h * w) for h, w in cs.LEVELS_1080P]
    for v in variants:
        run, got = v.call(inputs[2])
        run()
        first = [t.clone() for t in got]
        run()
        torch.cuda.synchronize()
        plain = ss2d_scan_pair_plain(*inputs[2], return_carries=True, variant="ssd", sub=SUB)
        err = {k: float((g - p).abs().max()) for k, g, p in zip(cs.K5_OUTPUTS, got, plain)}
        same = all(torch.equal(a, b) for a, b in zip(first, got))
        emit({"source": str(v.source), "check": "level3", "max_abs_err": err, "same_bits_twice": same,
              "tol": cs.K5_ATOL, **v.resources()})
        if not same or max(err.values()) > cs.K5_ATOL:
            sys.exit(f"k5_variants: {v.source} fails against the plain version: {err}, same bits {same}")
    for turn in range(args.turns):
        for v in variants:
            for level, args_ in enumerate(inputs, 1):
                run, _ = v.call(args_)
                row = {"source": str(v.source), "turn": turn, "level": level, "L": args_[0].shape[1],
                       "ms": cs.cuda_ms(run, 20), "bound_ms": cs.k5_bound(1, args_[0].shape[1], 64, 16, 2)[0]}
                if turn == 0:
                    row["phases_ms"] = cs.kernel_phases(run, cs.k5_phase_of, cs.K1_PHASES, "K5")
                    if level == 1:
                        row["clocks_sm_mhz"], row["power_draw_w"] = cs.clocks_under_load(run)
                emit(row)
    if out:
        out.close()


if __name__ == "__main__":
    sys.exit(main())
