"""WaveMamba inference CLI on PyTorch: `python -m wavemamba_torch.inference`.

The counterpart of the JAX package's `inference.py`, with the same flags:
enhance a folder of low-light images, optionally score PSNR/SSIM (Y channel,
crop_border=1) against a GT folder, save the outputs and print the averages.
Each image is reflect-padded to a x128 bucket (`models/buckets.py`), run
through the model and cropped back; with `--tile N` it goes through the model
in N x N tiles instead (`models/tiling.py`, 16 pixels of context, tiles padded
to a multiple of 8). Runs in float32 parity mode: TF32 is off for cuDNN
convolutions and cuBLAS matmuls. `--fast` runs `WaveMambaConfig.fast()`, the
bf16 preset (K1 on bf16 token streams), on the same path.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from wavemamba_torch.checkpoint import load_network
from wavemamba_torch.device import resolve_device
from wavemamba_torch.metrics import build_metric
from wavemamba_torch.models import build_network
from wavemamba_torch.models.buckets import BucketLadder, pad_to_shape
from wavemamba_torch.models.tiling import tiled_apply
from wavemamba_torch.models.wavemamba import WaveMambaConfig, pad_to_multiple, wavemamba_apply
from wavemamba_torch.utils.img_util import batch2img, img2batch, imread, imwrite
from wavemamba_torch.utils.misc import scandir

# Flags of the JAX CLI that the port does not serve yet, and where they wait.
NOT_PORTED = {
    "lpips_weights": "--lpips_weights waits for ROADMAP queue 1, item 11 (metrics/lpips.py)",
    "compile_cache": "--compile_cache waits for ROADMAP queue 1, item 10 (deployment)",
}


def set_parity_mode():
    """float32 parity: no TF32 in cuDNN convolutions or cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def enhance(model, batch: np.ndarray, ladder: BucketLadder | None, tile=0) -> np.ndarray:
    """(1, h, w, 3) RGB float32 -> the model's output cropped to (1, h, w, 3).
    Pads to the ladder's bucket, or to the image's own x128 multiple when
    `ladder` is None; with `tile` > 0, runs `tile` x `tile` tiles instead
    (tiles only need the model's x8 divisibility)."""
    dev = next(model.parameters()).device
    fwd = lambda x: wavemamba_apply(model, torch.from_numpy(np.ascontiguousarray(x)).to(dev))
    if tile:
        return tiled_apply(lambda t: fwd(t).cpu().numpy(), batch, tile_size=tile, pad_multiple=8)
    h, w = batch.shape[1:3]
    if ladder is None:
        x, _, _ = pad_to_multiple(batch, 128)
    else:
        x = pad_to_shape(batch, *ladder.shape_for(h, w))
    return fwd(x)[:, :h, :w].cpu().numpy()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-i", "--input", type=str, required=True, help="input (LQ) image folder")
    parser.add_argument("-g", "--gt", type=str, default=None, help="ground-truth folder")
    parser.add_argument("-w", "--weight", type=str, required=True, help="checkpoint (.pth)")
    parser.add_argument("-o", "--output", type=str, default="results/", help="output folder")
    parser.add_argument("-s", "--out_scale", type=int, default=1, help="output scale (1)")
    parser.add_argument("--suffix", type=str, default="", help="output filename suffix")
    parser.add_argument("--max_size", type=int, default=600 * 800,
                        help="max size before splitting (reference parity; unused)")
    parser.add_argument("--tile", type=int, default=0,
                        help="tile size; 0 (default) runs the whole image")
    parser.add_argument("--lpips_weights", type=str, default=None, help="(not ported yet)")
    parser.add_argument("--compile_cache", type=str, default=None, help="(not ported yet)")
    parser.add_argument("--no_bucket", action="store_true",
                        help="pad each image to its own 128-multiple instead of shared buckets")
    parser.add_argument("--bucket_waste", type=float, default=1.35,
                        help="max padded-area overhead before a new bucket is opened")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 preset (WaveMambaConfig.fast: K1 on bf16 token streams)")
    parser.add_argument("--wf", type=int, default=32)
    parser.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            sys.exit(f"not ported: {why}")
    if args.weight.endswith(".wmx"):
        sys.exit("not ported: .wmx artifacts wait for ROADMAP queue 1, item 10 (deployment)")
    set_parity_mode()
    dev = resolve_device(args.device)
    mk = WaveMambaConfig.fast if args.fast else WaveMambaConfig
    cfg = mk(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks), n_h_blocks=tuple(args.n_h_blocks))
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(cfg)},
                          load_network(args.weight, device=dev), device=dev)

    psnr = build_metric({"type": "psnr", "crop_border": 1, "test_y_channel": True})
    ssim = build_metric({"type": "ssim", "crop_border": 1, "test_y_channel": True})
    ladder = None if args.no_bucket else BucketLadder(max_waste=args.bucket_waste)
    os.makedirs(args.output, exist_ok=True)
    if os.path.isfile(args.input):
        paths = [args.input]
    else:
        paths = sorted(scandir(args.input, full_path=True))
    scores = {"psnr": [], "ssim": []}
    for path in paths:
        name = os.path.basename(path)
        img = imread(path)  # BGR uint8
        t0 = time.time()
        out = enhance(model, img2batch(img), ladder, tile=args.tile)
        line = f"{name}: {time.time() - t0:.3f}s"
        sr = batch2img(out)  # BGR uint8
        if args.gt:
            gt_path = os.path.join(args.gt, name)
            if os.path.exists(gt_path):
                gt = imread(gt_path)
                p, s = psnr(sr, gt), ssim(sr, gt)
                scores["psnr"].append(p)
                scores["ssim"].append(s)
                line += f"  psnr {p:.4f}  ssim {s:.4f}"
        print(line, flush=True)
        stem, ext = os.path.splitext(name)
        imwrite(sr, os.path.join(args.output, f"{stem}{args.suffix}{ext or '.png'}"))

    for k, v in scores.items():
        if v:
            print(f"avg {k}: {float(np.mean(v)):.4f}")
    if ladder is not None:
        print(f"buckets: {len(ladder.buckets)}")


if __name__ == "__main__":
    main()
