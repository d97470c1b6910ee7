"""Merge procedural datasets into one train dir through hardlinks (no extra
disk). The counterpart of `scripts/merge_datasets.py`: the same tree and the
same manifest. Source files keep their pixels (their manifests stay valid);
names are renumbered across the sources so they never collide.

    python -m wavemamba_torch.scripts.merge_datasets --out datasets/proc_llie_bsrgan_6k4 \
        datasets/proc_llie_bsrgan_xxl datasets/proc_llie_bsrgan_xxl2

The merged dir gets its own MANIFEST.json (`scripts/dataset_manifest.py`'s
format) recording the sources (each reproducible from its own generator
arguments) and the per-file hashes. The script links files and touches no
device.
"""

from __future__ import annotations

import argparse
import os

from wavemamba_torch.scripts.dataset_manifest import write


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="train")
    args = ap.parse_args(argv)

    for sub in ("gt", "input"):
        os.makedirs(os.path.join(args.out, args.split, sub), exist_ok=True)
    offset = 0
    for src in args.sources:
        gt_dir = os.path.join(src, args.split, "gt")
        lq_dir = os.path.join(src, args.split, "input")
        names = sorted(os.listdir(gt_dir))
        if sorted(os.listdir(lq_dir)) != names:
            raise SystemExit(f"{src}: gt/input mismatch")
        for i, name in enumerate(names):
            new = f"{offset + i:05d}.png"
            for sub, d in (("gt", gt_dir), ("input", lq_dir)):
                dst = os.path.join(args.out, args.split, sub, new)
                if not os.path.exists(dst):
                    os.link(os.path.join(d, name), dst)
        print(f"{src}: {len(names)} pairs -> offsets {offset}..{offset + len(names) - 1}")
        offset += len(names)
    write(args.out,
          generator_args=None,
          note="hardlink merge of: " + ", ".join(args.sources)
               + " (each reproducible from its own MANIFEST generator_args)")


if __name__ == "__main__":
    main()
