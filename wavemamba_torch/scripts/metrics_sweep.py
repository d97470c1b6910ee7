"""Batch metric evaluation of a results folder against a GT folder, with an
optional CSV. The counterpart of `scripts/metrics_sweep.py`, on the port's
metrics (`wavemamba_torch.metrics.build_metric`): the same rows, averages
and CSV.

Usage:
  python -m wavemamba_torch.scripts.metrics_sweep -p results/ -g gt/ -m psnr ssim [-o out.csv]

LPIPS (`-m lpips --lpips_weights <AlexNet-LPIPS state dict>`) runs on
`--device` (the card unless `--device cpu` is given) and is built before any
image is read, so a missing weights file fails at once, as in the inference
CLI. PSNR and SSIM run on the host.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--pred", required=True, help="predictions folder")
    parser.add_argument("-g", "--gt", default=None, help="ground-truth folder (FR metrics)")
    parser.add_argument("-m", "--metrics", nargs="+", default=["psnr", "ssim"])
    parser.add_argument("-o", "--out_csv", default=None)
    parser.add_argument("--crop_border", type=int, default=0)
    parser.add_argument("--y_channel", action="store_true")
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu, for LPIPS")
    args = parser.parse_args(argv)

    from wavemamba_torch.metrics import build_metric
    from wavemamba_torch.utils.img_util import imread
    from wavemamba_torch.utils.misc import scandir

    fns = {}
    for m in args.metrics:
        opt = {"type": m}
        if m in ("psnr", "ssim"):
            opt.update(crop_border=args.crop_border, test_y_channel=args.y_channel)
        if m == "lpips":
            opt["weights_path"] = args.lpips_weights
        fns[m] = build_metric(opt, device=args.device)

    rows = []
    for rel in sorted(scandir(args.pred)):
        pred = imread(os.path.join(args.pred, rel))
        row = {"name": rel}
        if args.gt:
            gt_path = os.path.join(args.gt, rel)
            if not os.path.exists(gt_path):
                print(f"skip {rel}: no GT", file=sys.stderr)
                continue
            gt = imread(gt_path)
            for m, fn in fns.items():
                row[m] = fn(pred, gt)
        rows.append(row)
        print("  ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{v}"
                        for k, v in row.items()))

    for m in args.metrics:
        vals = [r[m] for r in rows if m in r]
        if vals:
            print(f"Average {m}: {np.mean(vals):.6f}  (+/- {np.std(vals):.6f}, n={len(vals)})")

    if args.out_csv and rows:
        with open(args.out_csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {args.out_csv}")
    return rows


if __name__ == "__main__":
    main()
