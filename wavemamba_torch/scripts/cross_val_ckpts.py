"""Cross-checkpoint validation table: every trained checkpoint on every
validation set. The counterpart of `scripts/cross_val_ckpts.py`.

    python -m wavemamba_torch.scripts.cross_val_ckpts [--ckpt [KEY=]PATH ...] \
        [--val_root DIR ...] [-n 6] [--device cuda|cpu]

By default the eight shipped checkpoints (keys 004-011, as the JAX script
keys them) on `datasets/proc_llie` (clean low light), `proc_llie_bsrgan`
(composite degradations) and `proc_llie_bsrgan_xl` (the held-out set), the
first `-n` pairs of each `val/input` and `val/gt`. Checkpoints and sets that
are not on disk are skipped, each named. The model is `WaveMambaConfig()` in
float32 parity (`--wf` / `--n_l_blocks` / `--n_h_blocks` for another width),
so the fused scan runs as kernel K1 on the card; the PSNR is JAX's (the
clipped output against the GT, MSE in float64), averaged over the pairs.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from wavemamba_torch.models.wavemamba import WaveMambaConfig
from wavemamba_torch.scripts.common import (
    load_model,
    print_launches,
    psnr,
    read_rgb,
    repo_path,
    restore,
    set_parity_mode,
)

CKPTS = {
    "004": "ckpt/WaveMamba_ProcLLIE_512.pth",
    "005": "ckpt/WaveMamba_ProcLLIE_BSRGAN.pth",
    "006": "ckpt/WaveMamba_ProcLLIE_BSRGAN_12k.pth",
    "007": "ckpt/WaveMamba_ProcLLIE_BSRGAN_15k.pth",
    "008": "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL.pth",
    "009": "ckpt/WaveMamba_ProcLLIE_BSRGAN_6K4.pth",
    "010": "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL3.pth",
    "011": "ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth",
}
VAL_ROOTS = ("datasets/proc_llie", "datasets/proc_llie_bsrgan", "datasets/proc_llie_bsrgan_xl")


def _ckpt_arg(s):
    key, sep, path = s.partition("=")
    return (key, path) if sep else (os.path.splitext(os.path.basename(s))[0], s)


def pairs(val_root, n):
    """The first `n` (input, gt) paths of `val_root/val/{input,gt}`."""
    ins = sorted(glob.glob(os.path.join(val_root, "val", "input", "*.png")))[:n]
    gts = sorted(glob.glob(os.path.join(val_root, "val", "gt", "*.png")))[:n]
    return list(zip(ins, gts))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", action="append", type=_ckpt_arg, default=None,
                    help="[KEY=]PATH of a .pth, repeatable (default: the eight shipped ones)")
    ap.add_argument("--val_root", action="append", default=None,
                    help="a dataset dir holding val/input and val/gt, repeatable")
    ap.add_argument("-n", type=int, default=6, help="pairs of each set (the first n)")
    ap.add_argument("--wf", type=int, default=32)
    ap.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    set_parity_mode(args.device)
    ckpts = args.ckpt or [(k, repo_path(p)) for k, p in CKPTS.items()]
    roots = args.val_root or [repo_path(r) for r in VAL_ROOTS]
    cfg = WaveMambaConfig(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks),
                          n_h_blocks=tuple(args.n_h_blocks))
    models = {}
    for key, path in ckpts:
        if os.path.exists(path):
            models[key] = load_model(path, cfg, args.device)
        else:
            print(f"skip ckpt {key}: {path} not found", flush=True)
    table = {}
    for root in roots:
        ds = os.path.basename(os.path.normpath(root))
        found = pairs(root, args.n)
        if not found:
            print(f"skip {ds}: no pairs under {root}/val", flush=True)
            continue
        images = [(read_rgb(pi), read_rgb(pg)) for pi, pg in found]
        for key, model in models.items():
            vals = [psnr(np.clip(restore(model, x), 0, 1), g) for x, g in images]
            table[(ds, key)] = float(np.mean(vals))
            print(f"{ds:18s} ckpt {key}: PSNR {np.mean(vals):.4f} dB (n={len(vals)})", flush=True)
    print_launches()
    print("DONE", flush=True)
    return table


if __name__ == "__main__":
    main()
