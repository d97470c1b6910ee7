"""g++ builds of the port's host C++ sources into shared libraries under
`build/wavemamba_torch/`, each named by the hash of its source, the flags
and the host's CPU (`-march=native` ties a build to the CPU). An unchanged
build on the same CPU is made once. Host code; no device kernel."""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "wavemamba_torch"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17"]  # native/build.sh


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def build(source: Path, stem: str) -> Path:
    """Compile `source` into `BUILD_DIR/<stem>_<hash>.so`; returns its path."""
    key = b"\0".join([source.read_bytes(), " ".join(CXX_FLAGS).encode(), cpu_model().encode()])
    out = BUILD_DIR / f"{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out
