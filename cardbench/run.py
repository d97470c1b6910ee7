"""The benchmark of wavemamba_torch on NVIDIA GPUs: one run of one cell.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell needs is found by name:
the cell in `BENCHMARK.json`, its configuration in `configs/<config>.json`,
its traffic mix in `traffic/<traffic>.json`, whose `loop` names a module
of `loops/`, its limits in `limits/<workload>.json`, and each per-layer
metric's reader in `layer_metrics/<metric>.py`. With `--trace 0` the
result line carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from a profiled window.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared with its limit; the checks are also
the last lines of standard error. The run exits with a code other than 0,
and prints no result, where no CUDA device is present, where the cell asks
for more devices than there are, or where JAX or the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, before torch is imported

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wavemamba_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(bench: dict, workload: str, root: Path = HERE):
    """(cell entry, configuration, traffic mix, end-to-end metrics,
    per-layer metrics) of `workload`, its files under `root`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload]) and m["moves"] in reported]
    return cell, config, traffic, e2e, layer


def reader(metric: str, root: Path = HERE):
    """The `read(ctx)` of `layer_metrics/<metric>.py`."""
    path = root / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench.layer_metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, root: Path = HERE) -> dict:
    """One run of `workload` on `device`; returns the result object. `root`
    holds `configs/`, `traffic/`, `limits/` and `layer_metrics/`."""
    import torch

    from cardbench import check

    entry, config, traffic, e2e, layer = cell_spec(bench, workload, root)
    loop = importlib.import_module(f"cardbench.loops.{traffic['loop']}")
    dev = torch.device(device)
    out = loop.run(Cell(workload, config, traffic, seed, seconds, trace, dev, t_start))
    ok, checks = check.judge(out["numbers"], check.load_limits(workload, root / "limits"))
    ok = ok and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in e2e + layer}
    if trace:
        ctx = out["layer_ctx"]
        values = {m["name"]: reader(m["name"], root)(ctx) for m in layer}
    else:
        values = {**out["e2e"], "setup_s": out["setup_s"]}
        values = {m["name"]: values.get(m["name"]) for m in e2e}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    on_card = dev.type == "cuda"
    result = {"correct": ok, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                         "count": entry["chips"],
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        from cardbench import trace as tr

        traced = out["trace"]
        result["device"].update(busy_s=traced.busy_s(), window_s=traced.window_s)
        result["breakdown"] = tr.breakdown(traced)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = cell_spec(bench, args.workload)[0]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
