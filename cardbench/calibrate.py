"""Readings that a cell's limits are set from: the compared numbers of sound
program runs over many seeds, and of the control (the loop's `control`:
the reference one precision down, put in the program's place) over a few,
in one process on the card.

    python3 -m cardbench.calibrate --workload <name> --seeds 11 12 ... \
        --control-seeds 21 22 23 --seconds 10 [--out FILE]

Each program seed is a whole run of the cell's loop, tracing off, with a
window of `--seconds`. Each line printed is one JSON object: the seed, the
side ('program' or 'control'), every number the loop read (the limits
hold some of them) and, for the program, its end-to-end readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from cardbench import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, traffic, _, _ = run.cell_spec(bench, args.workload)
    loop = importlib.import_module(f"cardbench.loops.{traffic['loop']}")
    rows = []

    def cell(seed):
        return run.Cell(args.workload, config, traffic, seed, args.seconds, False,
                        torch.device("cuda:0"), time.perf_counter())

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        out = loop.run(cell(seed))
        emit({"side": "program", "seed": seed, "failed": out["failed"],
              "numbers": out["numbers"], "e2e": out["e2e"], "setup_s": out["setup_s"]})
    for seed in args.control_seeds:
        emit({"side": "control", "seed": seed, "numbers": loop.control(cell(seed))})
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
