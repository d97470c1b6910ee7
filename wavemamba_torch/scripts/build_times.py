"""Cold build times of the port's kernel sources.

`python -m wavemamba_torch.scripts.build_times [--source PATH ...] [--repeat N]`
builds each source (by default every `csrc/*.cu`, as `utils/cxx.py:build_all`
finds them) the way the port does (`cxx.build`), one after another so that no two
builds share the host's cores, each into an empty directory under
`build/build_times/`, and prints one JSON line per build: the source, the
seconds `nvcc` took and the host's CPU count. A source from another checkout
(an earlier commit's, unpacked with `git archive`) is built with the headers
beside it. Needs `nvcc`, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

from wavemamba_torch.utils import cxx

OUT_DIR = cxx.BUILD_DIR.parent / "build_times"


def cold_build_s(source: Path) -> float:
    """Seconds of one build of `source` from nothing."""
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    default = cxx.BUILD_DIR
    cxx.set_build_dir(OUT_DIR)
    try:
        cxx.build(source)
    finally:
        cxx.set_build_dir(default)
        shutil.rmtree(OUT_DIR, ignore_errors=True)
    return cxx.BUILD_SECONDS[source.name]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", type=Path,
                        help="a .cu file to build (repeatable); default: every source of the port")
    parser.add_argument("--repeat", type=int, default=1, help="builds of each source, in turn")
    args = parser.parse_args(argv)
    for _ in range(args.repeat):
        for source in args.source or sorted(cxx.CSRC.glob("*.cu")):
            print(json.dumps({"source": str(source), "build_s": cold_build_s(source.resolve()),
                              "cpus": os.cpu_count()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
