"""Post-training steps for a finished experiment. The counterpart of
`scripts/post_train_eval.py`.

    python -m wavemamba_torch.scripts.post_train_eval --exp experiments/007_WaveMamba_ProcLLIE_BSRGAN_15k \
        --out ckpt/WaveMamba_ProcLLIE_BSRGAN_15k.pth --val datasets/proc_llie_bsrgan_xl/val \
        --prefix bsrgan15k [--samples_dir DIR] [--device cuda|cpu]

1. Prints the validation trajectory from the run's newest `train_*.log`.
2. Writes the chosen `models/<model>.pth` (default `net_g_best_latest`) to
   `--out` as `{'params': state_dict}`, the reference's layout, and checks
   it with `load_state_dict(strict=True)` into the port's `WaveMamba` at
   `--wf` / `--n_l_blocks` / `--n_h_blocks`.
3. For the first `--n-samples` pairs of `--val` (`input/`, `gt/`): the
   float32 forward on `--device` (the card by default) against the same
   forward on the CPU, max |d|, the PSNR of the input and of the output
   against the GT, and the input and the restored image written to
   `--samples_dir` (default `ckpt/samples`) as `<prefix>_NN_{input,restored}.png`.

The JAX script checks the file against the original PyTorch model, which is
not part of this repository; the port's tests hold the written `.pth`
against the JAX package's `load_network` and forward instead. Follow with
`python -m wavemamba_torch.scripts.cross_val_ckpts` for the table over every
validation set.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from wavemamba_torch.scripts.common import (
    print_launches,
    psnr,
    read_rgb,
    repo_path,
    restore,
    set_parity_mode,
    write_rgb,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exp", required=True, help="experiment dir")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--val", required=True, help="val dir holding input/ and gt/ subfolders")
    ap.add_argument("--prefix", default="run",
                    help="<samples_dir>/<prefix>_NN_{input,restored}.png")
    ap.add_argument("--model", default="net_g_best_latest",
                    help="which models/ entry to export (without .pth)")
    ap.add_argument("--n-samples", type=int, default=2)
    ap.add_argument("--wf", type=int, default=32)
    ap.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    ap.add_argument("--samples_dir", default=repo_path("ckpt", "samples"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.device import resolve_device
    from wavemamba_torch.models.wavemamba import WaveMamba, WaveMambaConfig

    dev = resolve_device(args.device)
    set_parity_mode(dev)

    # 1) val trajectory from the train log
    logs = sorted(glob.glob(os.path.join(args.exp, "train_*.log")))
    if logs:
        with open(logs[-1]) as f:
            for line in f:
                if "psnr" in line:
                    print(line.strip()[-120:])

    # 2) export the chosen snapshot in the reference's layout, then load it strictly
    sd = load_network(os.path.join(args.exp, "models", f"{args.model}.pth"), device="cpu")
    sd = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"params": sd}, args.out)
    print("exported", args.out)
    cfg = WaveMambaConfig(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks),
                          n_h_blocks=tuple(args.n_h_blocks))
    cpu_model = WaveMamba(cfg).eval()
    cpu_model.load_state_dict(load_network(args.out, device="cpu"), strict=True)
    print("strict load ok")
    model = WaveMamba(cfg).to(dev).eval()
    model.load_state_dict(load_network(args.out, device=dev), strict=True)

    # 3) the device's forward against the CPU's, and before/after samples
    val_in = sorted(glob.glob(os.path.join(args.val, "input", "*.png")))
    val_gt = sorted(glob.glob(os.path.join(args.val, "gt", "*.png")))
    rows = []
    for i, (pi, pg) in enumerate(list(zip(val_in, val_gt))[:args.n_samples]):
        img, gt = read_rgb(pi), read_rgb(pg)
        y = restore(model, img)
        d = float(np.abs(y - restore(cpu_model, img)).max())
        rows.append({"max_abs_vs_cpu": d, "psnr_in": psnr(img, gt),
                     "psnr_out": psnr(np.clip(y, 0, 1), gt)})
        print(f"img{i}: {dev.type} vs cpu max|d|={d:.2e}  PSNR in={rows[-1]['psnr_in']:.2f} -> "
              f"out={rows[-1]['psnr_out']:.2f} dB")
        write_rgb(img, os.path.join(args.samples_dir, f"{args.prefix}_{i:02d}_input.png"))
        write_rgb(y, os.path.join(args.samples_dir, f"{args.prefix}_{i:02d}_restored.png"))
    print("run python -m wavemamba_torch.scripts.cross_val_ckpts for the cross-checkpoint table")
    print_launches()
    print("DONE")
    return rows


if __name__ == "__main__":
    main()
