"""Tiled-against-whole fidelity of a trained checkpoint on the card. The
counterpart of `scripts/tpu_tiled_fidelity.py`.

    python -m wavemamba_torch.scripts.tiled_fidelity [--ckpt PATH] [--val_dir DIR] [--device cuda|cpu]

Loads `ckpt/WaveMamba_ProcLLIE_512.pth` under `WaveMambaConfig.fast()`
(bf16, K1 on bf16 streams), builds a 1080x1920 low-light frame as a mosaic
of the `--val_dir` images (default `datasets/proc_llie/val/input`; three
rows of four, cropped), and runs it whole (reflect-padded to a multiple of
8) and through `models/tiling.tiled_apply` at tile 240, pad 16 (the
reference's seam contract), batch 8. Prints each route's first run in
seconds, the PSNR and max |d| between the two outputs, the means of the
input and of both outputs, and one JSON line of them.
"""

from __future__ import annotations

import argparse
import glob
import json
import time

import numpy as np
import torch

from wavemamba_torch.models.wavemamba import WaveMambaConfig
from wavemamba_torch.scripts.common import (
    load_model,
    print_launches,
    psnr,
    read_rgb,
    repo_path,
    restore,
)


TILE_PAD = 16  # the reference's seam contract


def mosaic(paths, height, width):
    """Three rows of four images (cycling through `paths`), cropped."""
    imgs = [read_rgb(p) for p in paths]
    rows = [np.concatenate([imgs[(r * 4 + c) % len(imgs)] for c in range(4)], axis=1)
            for r in range(3)]
    return np.ascontiguousarray(np.concatenate(rows, axis=0)[:height, :width][None])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=repo_path("ckpt", "WaveMamba_ProcLLIE_512.pth"))
    ap.add_argument("--val_dir", default=repo_path("datasets", "proc_llie", "val", "input"))
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--tile", type=int, default=240)
    ap.add_argument("--tile_batch", type=int, default=8)
    ap.add_argument("--wf", type=int, default=32)
    ap.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from wavemamba_torch.device import resolve_device
    from wavemamba_torch.models.tiling import tiled_apply
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    dev = resolve_device(args.device)
    paths = sorted(glob.glob(f"{args.val_dir}/*.png"))
    if not paths:
        raise SystemExit(f"no images under {args.val_dir}")
    x = mosaic(paths, args.height, args.width)
    cfg = WaveMambaConfig.fast(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks),
                               n_h_blocks=tuple(args.n_h_blocks))
    model = load_model(args.ckpt, cfg, dev)
    print(f"{args.ckpt} on {dev}, frame {x.shape[1]}x{x.shape[2]}", flush=True)

    def fwd(t):
        y = wavemamba_apply(model, torch.from_numpy(np.ascontiguousarray(t)).to(dev))
        return y.cpu().numpy()

    t0 = time.time()
    whole = restore(model, x)
    whole_s = time.time() - t0
    print(f"whole frame, first run {whole_s:.1f}s", flush=True)
    t0 = time.time()
    tiled = tiled_apply(fwd, x, tile_size=args.tile, tile_pad=TILE_PAD, pad_multiple=8,
                        tile_batch=args.tile_batch)
    tiled_s = time.time() - t0
    print(f"tiled, first run {tiled_s:.1f}s", flush=True)
    row = {"frame": list(x.shape[1:3]), "tile": [args.tile, TILE_PAD, args.tile_batch],
           "psnr": psnr(whole, tiled), "max_abs": float(np.max(np.abs(whole - tiled))),
           "mean_input": float(x.mean()), "mean_whole": float(whole.mean()),
           "mean_tiled": float(tiled.mean()), "whole_s": whole_s, "tiled_s": tiled_s,
           "finite": bool(np.isfinite(whole).all() and np.isfinite(tiled).all())}
    print(f"tiled-vs-whole PSNR {row['psnr']:.2f} dB (max|d| {row['max_abs']:.5f})", flush=True)
    print(f"  input mean {row['mean_input']:.3f} -> whole {row['mean_whole']:.3f} "
          f"tiled {row['mean_tiled']:.3f}", flush=True)
    print(json.dumps({"tiled_fidelity": row}), flush=True)
    print_launches()
    return row


if __name__ == "__main__":
    main()
