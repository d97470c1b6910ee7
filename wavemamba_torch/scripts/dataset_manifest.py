"""Freeze / verify a dataset's manifest. The counterpart of
`scripts/dataset_manifest.py`, in the same format, byte for byte.

Absolute PSNR comparisons across runs mean something only against a frozen
validation set. A MANIFEST.json next to each procedural dataset records the
generator's arguments (the port's `python -m
wavemamba_torch.scripts.make_proc_dataset` and the JAX package's
`scripts/make_proc_dataset.py` write the same bytes from them on one host;
the `generator` field keeps the JAX script's name, so a manifest written by
either script verifies under the other) and the sha256 of every file.
The script hashes files and touches no device.

Usage:
    python -m wavemamba_torch.scripts.dataset_manifest write datasets/proc_llie_bsrgan_xl \
        --generator-args '--bsrgan --seed 2 --n-train 800 --n-val 15 --size 512'
    python -m wavemamba_torch.scripts.dataset_manifest verify datasets/proc_llie_bsrgan_xl
    python -m wavemamba_torch.scripts.dataset_manifest verify datasets/... --split val

`verify` exits 1 when a file is modified or missing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def _iter_files(root):
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f == "MANIFEST.json":
                continue
            p = os.path.join(dirpath, f)
            yield os.path.relpath(p, root)


def _sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            b = fh.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def build_manifest(root, generator_args=None, note=None):
    files = {rel: _sha256(os.path.join(root, rel)) for rel in _iter_files(root)}
    if not files:
        raise SystemExit(f"no files under {root}")
    manifest = {
        "generator": "scripts/make_proc_dataset.py",
        "generator_args": generator_args,
        "note": note,
        "n_files": len(files),
        "files": files,
    }
    return manifest


def write(root, generator_args=None, note=None):
    manifest = build_manifest(root, generator_args, note)
    path = os.path.join(root, "MANIFEST.json")
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    print(f"wrote {path}: {manifest['n_files']} files")
    return manifest


def verify(root, split=None):
    path = os.path.join(root, "MANIFEST.json")
    with open(path) as fh:
        manifest = json.load(fh)
    bad, missing, checked = [], [], 0
    for rel, want in manifest["files"].items():
        if split and not rel.startswith(split + os.sep):
            continue
        p = os.path.join(root, rel)
        if not os.path.exists(p):
            missing.append(rel)
        elif _sha256(p) != want:
            bad.append(rel)
        else:
            checked += 1
    if bad or missing:
        print(f"FAIL: {len(bad)} modified, {len(missing)} missing "
              f"(first: {(bad + missing)[:3]})")
        return False
    print(f"ok: {checked} files match {path}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["write", "verify"])
    ap.add_argument("root")
    ap.add_argument("--generator-args", default=None,
                    help="exact make_proc_dataset.py argument string that "
                         "reproduces this dataset bit-exactly")
    ap.add_argument("--note", default=None)
    ap.add_argument("--split", default=None,
                    help="verify only files under this subdir (e.g. val)")
    args = ap.parse_args(argv)
    if args.cmd == "write":
        write(args.root, args.generator_args, args.note)
    else:
        sys.exit(0 if verify(args.root, args.split) else 1)


if __name__ == "__main__":
    main()
