"""Sweep the 1x1 lowering policy per region on the card. The counterpart of
`scripts/tpu_1x1_sweep.py`.

Under `compute_dtype='bfloat16'` every 1x1 conv with stride 1 is a token
matmul (`ops/nn.py:Conv2d`) unless its region is named in
`WaveMambaConfig.conv1x1_as_conv` ('ffn': the LFSS FFN; 'hfe': the HFE
blocks' qkv, PAConv and FeedForward 1x1s), which keeps it a conv. For each
of the four variants (), ('ffn',), ('hfe',) and ('ffn', 'hfe') the script
builds `WaveMambaConfig.fast(conv1x1_as_conv=variant)` with seeded weights
and prints the median ms of a forward on one seeded 1080x1920 frame (the
mean of `--iters` forwards, median over `--reps`, after a warm-up; CUDA
events on the card), its K1 launches a forward, its PSNR against the
variant () and against the float32 forward on the same weights, and last
one JSON line of the rows.

    python -m wavemamba_torch.scripts.conv1x1_sweep [--height 1080 --width 1920] [--device cuda|cpu]

On the CPU (`--device cpu`, a small `--height` / `--width` / `--wf`) it
runs the kernels' plain versions: its times are not the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from wavemamba_torch.models.wavemamba import WaveMambaConfig
from wavemamba_torch.scripts.common import (
    launches,
    median_ms,
    print_launches,
    psnr,
    set_parity_mode,
)

VARIANTS = [(), ("ffn",), ("hfe",), ("ffn", "hfe")]


def build(cfg, device, seed=0):
    """The model of `cfg` with weights drawn from `seed` (the same for every
    variant: the variants share their parameters)."""
    from wavemamba_torch.models import init_network

    return init_network({"type": "WaveMamba", **dataclasses.asdict(cfg)},
                        torch.Generator().manual_seed(seed), device=device, train=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10, help="forwards a timed rep")
    ap.add_argument("--wf", type=int, default=32)
    ap.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from wavemamba_torch.device import resolve_device
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    dev = resolve_device(args.device)
    set_parity_mode(dev)
    arch = dict(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks), n_h_blocks=tuple(args.n_h_blocks))
    x = torch.from_numpy(np.random.RandomState(0).rand(1, args.height, args.width, 3)
                         .astype(np.float32)).to(dev)
    reference = wavemamba_apply(build(WaveMambaConfig(**arch), dev), x).cpu().numpy()
    rows, base = [], None
    for sites in VARIANTS:
        model = build(WaveMambaConfig.fast(conv1x1_as_conv=sites, **arch), dev)
        before = launches()["K1"]
        y = wavemamba_apply(model, x).cpu().numpy()
        k1 = launches()["K1"] - before
        ms = median_ms(lambda: wavemamba_apply(model, x), dev, reps=args.reps, iters=args.iters)
        base = y if base is None else base
        row = {"conv1x1_as_conv": list(sites), "ms": ms, "k1_per_forward": k1,
               "finite": bool(np.isfinite(y).all()), "psnr_vs_default": psnr(y, base),
               "psnr_vs_float32": psnr(y, reference)}
        rows.append(row)
        print(f"conv1x1_as_conv={sites!r:18} {args.height}x{args.width} median {ms:8.3f} ms  "
              f"K1 {k1} a forward  PSNR vs () {row['psnr_vs_default']:.2f} dB, "
              f"vs float32 {row['psnr_vs_float32']:.2f} dB", flush=True)
        del model
    print(json.dumps({"conv1x1_sweep": rows, "shape": [1, args.height, args.width, 3],
                      "device": str(dev)}), flush=True)
    print_launches()
    return rows


if __name__ == "__main__":
    main()
