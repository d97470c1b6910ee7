"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the program."""

import json
import subprocess
import sys

from cardbench import run

FORBIDDEN = ["jax", "jaxlib", "flax", "wavemamba_tpu"]
PROBE = """
import importlib, json, sys
from pathlib import Path
for name in {modules!r}:
    importlib.import_module(name)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(modules, extra=""):
    out = subprocess.run([sys.executable, "-c", PROBE.format(modules=modules, extra=extra)],
                         capture_output=True, text=True, cwd=run.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loops_and_readers_load_no_jax():
    readers = "\n".join(f"run.reader({p.stem!r})" for p in (run.HERE / "layer_metrics").glob("*.py")
                        if p.stem != "__init__")
    names = _top_level_names(
        ["cardbench.run", "cardbench.calibrate", "cardbench.loops.serve",
         "cardbench.loops.train", "wavemamba_torch.inference", "wavemamba_torch.runner"],
        extra="from cardbench import run\n" + readers)
    assert not names & set(FORBIDDEN)
    assert "wavemamba_torch" in names  # the probe did load the program


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(["cardbench.reference.wavemamba", "cardbench.reference.scan",
                              "cardbench.reference.init", "cardbench.reference.train"])
    assert not names & set(FORBIDDEN + ["wavemamba_torch"])
