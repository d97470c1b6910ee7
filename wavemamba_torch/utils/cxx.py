"""The port's native boundary: how a C++ or CUDA source becomes a loaded
library, and how Python calls into it. Every compiled library of the port
(K1-K5 and ART's attention in `ops/`, the conv chains K6 / K7, the probes
P1-P5, and the host passes of `utils/frames.py` and `data/native.py`) is
built, loaded and called through this module.

`build(source)` compiles a `.cu` with `nvcc` for sm_90a (`NVCC_FLAGS`) or a
`.cc` with g++ (`CXX_FLAGS`) into one shared library under `BUILD_DIR`
(`build/wavemamba_torch/` unless `set_build_dir` names another), named by a
hash: for `nvcc` of the source, every header in its directory (a source may
include any of them) and the flags; for g++ of the source, the flags and the
host's CPU (`-march=native` ties a build to the CPU). An unchanged build is
made once. `build_all()` builds every `csrc/*.cu` on disk.

`load(source, table, kernel)` declares a built library's entries; a `.cu`
library needs a CUDA device and also binds its `<stem>_error_string`.
The host passes catch what `load` raises and take their numpy routes;
a kernel has no such fallback.
`launch(lib, entry, device, *args)` calls a kernel's C entry on `device`'s
current stream and raises with the library's own error string. Importing
this module needs neither compiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "wavemamba_torch" / "csrc"
BUILD_DIR = ROOT / "build" / "wavemamba_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17"]  # native/build.sh
BUILD_SECONDS: dict[str, float] = {}  # source name -> seconds of its compiler run in this process


def set_build_dir(path) -> Path:
    """Build and look up every library in `path` from here on (created if
    need be); returns it, resolved."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels are built from source")


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def build(source: Path, stem: str | None = None) -> Path:
    """Compile `source` into `BUILD_DIR/<stem>_<hash>.so` (stem: the
    source's); returns its path. `nvcc`'s resource report (`-Xptxas -v`) is
    kept beside its library as a `.log` file, and the seconds the compiler
    took in `BUILD_SECONDS`."""
    if source.suffix == ".cu":
        key = b"\0".join(p.read_bytes() for p in [source, *sorted(source.parent.glob("*.cuh"))])
        key += "\0".join(NVCC_FLAGS).encode()
        cmd = [nvcc(), *NVCC_FLAGS]
    else:
        key = b"\0".join([source.read_bytes(), " ".join(CXX_FLAGS).encode(), cpu_model().encode()])
        cmd = ["g++", *CXX_FLAGS]
    out = BUILD_DIR / f"{stem or source.stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", str(tmp), str(source)], capture_output=True, text=True)
    BUILD_SECONDS[source.name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stderr}")
    if source.suffix == ".cu":
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Every `csrc/*.cu` on disk, one `nvcc` each, started together:
    {source name: library}."""
    sources = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip((s.name for s in sources), pool.map(build, sources)))


def load(source: Path, table: dict, kernel: str | None = None, stem: str | None = None,
         prefix: str | None = None):
    """The library of `source` (`build(source, stem)`) with each entry of
    `table`, {name: (argtypes, restype)}, declared. A `.cu` library needs a
    CUDA device: without one this raises a RuntimeError naming `kernel`; its
    `<prefix>_error_string` (prefix: the source's stem) is bound as
    `lib.error_string`, which `call` and `launch` read."""
    cuda = source.suffix == ".cu"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"the {kernel} kernel needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    lib = ctypes.CDLL(str(build(source, stem)))
    for name, (argtypes, restype) in table.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    if cuda:
        lib.error_string = getattr(lib, f"{prefix or source.stem}_error_string")
        lib.error_string.argtypes, lib.error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


@functools.cache
def sm_count(index):
    """The SMs of CUDA device `index` (None: the current device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(device):
    """A context that makes `device` current, or none where it is already
    (switching costs the host some microseconds a launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def call(lib, entry, *args):
    """`entry` of a `load`ed `.cu` library on `args`; raises with the
    library's own error string where it returns non-zero."""
    err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} failed: {lib.error_string(err).decode()}")


def launch(lib, entry, device, *args):
    """One launch through the kernel entry `entry` of `lib`: `call` with
    `device` current (`on_device`) and its current stream appended to
    `args`."""
    with on_device(device):
        call(lib, entry, *args, torch.cuda.current_stream().cuda_stream)
