"""Localize the tiled-vs-whole error: a seam artifact, or the global receptive
field of the scans? The counterpart of `scripts/tiled_localize.py`.

    python -m wavemamba_torch.scripts.tiled_localize [--ckpt PATH] [--input PNG] \
        [--crop 256] [--tiles 64 128] [--device cuda|cpu]

Runs a trained checkpoint (default `ckpt/WaveMamba_ProcLLIE_512.pth`) in
float32 parity, which keeps bf16 noise out of the comparison, on a square
crop of one image (default the first of `datasets/proc_llie/val/input`),
whole and through `models/tiling.tiled_apply` (pad 16, batch 4), and prints
for each tile size the PSNR between the two and the mean |d| in the band
within 4 px of an interior tile boundary against the interior. An error
spread evenly over the tiles is the scans' state differing per tile, not a
stitching fault.
"""

from __future__ import annotations

import argparse
import glob

import numpy as np
import torch

from wavemamba_torch.models.wavemamba import WaveMambaConfig
from wavemamba_torch.scripts.common import (
    load_model,
    print_launches,
    psnr,
    read_rgb,
    repo_path,
    set_parity_mode,
)


def localize(model, x, tile_sizes, tile_pad=16, tile_batch=4):
    """x: (1, S, S, 3). Returns (whole, {tile size: (tiled, row)})."""
    from wavemamba_torch.models.tiling import tiled_apply
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    dev = next(model.parameters()).device
    fwd = lambda t: wavemamba_apply(model, torch.from_numpy(np.ascontiguousarray(t)).to(dev)).cpu().numpy()
    whole = fwd(x)
    size = x.shape[1]
    out = {}
    for ts in tile_sizes:
        tiled = tiled_apply(fwd, x, tile_size=ts, tile_pad=tile_pad, pad_multiple=8,
                            tile_batch=tile_batch)
        err = np.abs(whole - tiled)[0].mean(-1)  # (H, W)
        seam = np.zeros((size, size), bool)
        for b in range(ts, size, ts):
            seam[max(0, b - 4):b + 4, :] = True
            seam[:, max(0, b - 4):b + 4] = True
        row = {"psnr": psnr(whole, tiled), "seam": float(err[seam].mean()),
               "interior": float(err[~seam].mean())}
        row["ratio"] = row["seam"] / row["interior"]
        out[ts] = (tiled, row)
    return whole, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=repo_path("ckpt", "WaveMamba_ProcLLIE_512.pth"))
    ap.add_argument("--input", default=None,
                    help="an image (default: the first of datasets/proc_llie/val/input)")
    ap.add_argument("--crop", type=int, default=256, help="side of the top-left square crop")
    ap.add_argument("--tiles", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--wf", type=int, default=32)
    ap.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    path = args.input
    if path is None:
        found = sorted(glob.glob(repo_path("datasets", "proc_llie", "val", "input", "*.png")))
        if not found:
            raise SystemExit("no --input given and no datasets/proc_llie/val/input/*.png")
        path = found[0]
    img = read_rgb(path)
    if min(img.shape[:2]) < args.crop:
        raise SystemExit(f"{path}: {img.shape[:2]} is smaller than the {args.crop} crop")
    x = np.ascontiguousarray(img[None, :args.crop, :args.crop])
    set_parity_mode(args.device)
    cfg = WaveMambaConfig(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks),
                          n_h_blocks=tuple(args.n_h_blocks))
    model = load_model(args.ckpt, cfg, args.device)
    _, out = localize(model, x, args.tiles)
    for ts, (_, r) in out.items():
        print(f"tile={ts}: PSNR {r['psnr']:.2f} dB  mean|d| seam-band {r['seam']:.5f} vs interior "
              f"{r['interior']:.5f}  (ratio {r['ratio']:.2f})", flush=True)
    print_launches()
    print("DONE", flush=True)
    return {ts: r for ts, (_, r) in out.items()}


if __name__ == "__main__":
    main()
