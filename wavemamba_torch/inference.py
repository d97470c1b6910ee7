"""WaveMamba inference CLI on PyTorch: `python -m wavemamba_torch.inference`.

The counterpart of the JAX package's `inference.py`, with the same flags:
enhance a folder of low-light images, optionally score PSNR/SSIM (Y channel,
crop_border=1) against a GT folder, save the outputs and print the averages.
Each image is reflect-padded to a x128 bucket (`models/buckets.py`), run
through the model and cropped back; with `--tile N` it goes through the model
in N x N tiles instead (`models/tiling.py`, 16 pixels of context, tiles padded
to a multiple of 8). Runs in float32 parity mode: TF32 is off for cuDNN
convolutions and cuBLAS matmuls. `--fast` runs `WaveMambaConfig.fast()`, the
bf16 preset (K1 on bf16 token streams), on the same path. `-opt YML` serves
the yml's `network_g` instead, any registered arch (`models.build_network`:
'WaveMamba', 'ART', or one in `ARCH_REGISTRY`), on the same path; it names
the network, so it takes none of `--fast`, `--wf`, `--n_l_blocks` and
`--n_h_blocks`.

`-w` takes a `.wmt` deployment artifact too (`wavemamba_torch/deploy.py`,
`python -m wavemamba_torch.scripts.export_model export`): the artifact pads to
its own exported buckets (`--tile`: its tile program) and serves each on the
card through one CUDA graph; a uint8 artifact takes and gives bytes.
`--compile_cache DIR` is the directory where the kernels and the host passes
(`utils/frames.py`, `data/native.py`) are built and looked up, so a later
process loads K1 instead of building it. `.wmx` artifacts are
the JAX package's. An artifact whose tile program is sharded over N ranks
(`export_model export --tile T --mesh_devices N`) serves `--tile` under
`torchrun --standalone --nproc_per_node=N -m wavemamba_torch.inference ...`:
every rank takes its share of each tile batch, and rank 0 alone prints and
writes. `--lpips_weights` (with `-g`) also scores LPIPS (AlexNet,
`metrics/lpips.py`) from that state dict. `--trace DIR` writes a Chrome
trace of the run (`utils/profiler.trace`, read by
`python -m wavemamba_torch.scripts.trace_topops DIR`): each image is a
`wm.request` span, its file name in the span's `args`, around its `wm.*`
spans (`img2batch`, `enhance`'s pad, H2D, forward and D2H, `batch2img`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from wavemamba_torch.checkpoint import load_network
from wavemamba_torch.deploy import SUFFIX, enable_compilation_cache, load_exported
from wavemamba_torch.metrics import build_metric
from wavemamba_torch.models import build_network, network_apply
from wavemamba_torch.models.buckets import BucketLadder, pad_to_shape
from wavemamba_torch.models.tiling import tiled_apply
from wavemamba_torch.models.wavemamba import WaveMambaConfig, pad_to_multiple
from wavemamba_torch.parallel import initialize, is_master
from wavemamba_torch.parallel.dist import shutdown
from wavemamba_torch.utils.img_util import batch2img, img2batch, imread, imwrite
from wavemamba_torch.utils.misc import scandir
from wavemamba_torch.utils.options import yaml_load
from wavemamba_torch.utils.profiler import annotate, trace

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

    def fwd(x, h=None, w=None):
        with annotate("wm.enhance.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        with annotate("wm.enhance.forward"):  # the host's enqueue of the forward
            y = network_apply(model, x)
        with annotate("wm.enhance.d2h"):  # waits for the forward's last kernels
            return y[:, :h, :w].cpu().numpy()

    if tile:
        return tiled_apply(fwd, batch, tile_size=tile, pad_multiple=8)
    h, w = batch.shape[1:3]
    with annotate("wm.enhance.pad"):
        if ladder is None:
            x, _, _ = pad_to_multiple(batch, 128)
        else:
            x = pad_to_shape(batch, *ladder.shape_for(h, w))
    return fwd(x, h, w)


def network_g_of(args) -> dict:
    """The `network_g` the CLI serves: the options yml's (`--opt`), else
    WaveMamba from `--wf`, `--n_l_blocks` and `--n_h_blocks`, under `--fast`
    its bf16 preset."""
    if args.opt:
        return dict(yaml_load(args.opt)["network_g"])
    mk = WaveMambaConfig.fast if args.fast else WaveMambaConfig
    cfg = mk(wf=args.wf or 32, n_l_blocks=tuple(args.n_l_blocks or (1, 2, 4)),
             n_h_blocks=tuple(args.n_h_blocks or (1, 1, 2)))
    return {"type": "WaveMamba", **dataclasses.asdict(cfg)}


def load_model(network_g: dict, weights, device):
    """The model the CLI serves: `network_g` (any registered arch) built
    through `build_network`, `weights` (a `.pth` path, or a state dict)
    loaded strictly, in eval mode on `device`."""
    if isinstance(weights, str):
        weights = load_network(weights, device=device)
    return build_network(network_g, weights, device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-i", "--input", type=str, required=True, help="input (LQ) image folder")
    parser.add_argument("-g", "--gt", type=str, default=None, help="ground-truth folder")
    parser.add_argument("-w", "--weight", type=str, required=True,
                        help=f"checkpoint (.pth) or deployment artifact ({SUFFIX})")
    parser.add_argument("-o", "--output", type=str, default="results/", help="output folder")
    parser.add_argument("-s", "--out_scale", type=int, default=1, help="output scale (1)")
    parser.add_argument("--suffix", type=str, default="", help="output filename suffix")
    parser.add_argument("--max_size", type=int, default=600 * 800,
                        help="max size before splitting (reference parity; unused)")
    parser.add_argument("--tile", type=int, default=0,
                        help="tile size; 0 (default) runs the whole image")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="AlexNet LPIPS state-dict path (optional; scored with -g)")
    parser.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                        help="directory where the kernels and the host passes are built and "
                             "looked up: a later process loads K1 instead of building it")
    parser.add_argument("--no_bucket", action="store_true",
                        help="pad each image to its own 128-multiple instead of shared buckets")
    parser.add_argument("--bucket_waste", type=float, default=1.35,
                        help="max padded-area overhead before a new bucket is opened")
    parser.add_argument("-opt", "--opt", type=str, default=None, metavar="YML",
                        help="serve this options yml's network_g, any registered arch (ART, ...)")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 preset (WaveMambaConfig.fast: K1 on bf16 token streams)")
    parser.add_argument("--wf", type=int, default=None, help="WaveMamba's width (32)")
    parser.add_argument("--n_l_blocks", type=int, nargs="+", default=None, help="(1 2 4)")
    parser.add_argument("--n_h_blocks", type=int, nargs="+", default=None, help="(1 1 2)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the run into DIR, each image "
                             "a wm.request span")
    args = parser.parse_args(argv)
    if args.opt:
        clash = [flag for flag, given in (("--fast", args.fast), ("--wf", args.wf),
                                          ("--n_l_blocks", args.n_l_blocks),
                                          ("--n_h_blocks", args.n_h_blocks)) if given]
        if clash:
            parser.error(f"-opt/--opt names the network: it takes no {', '.join(clash)}")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.weight.endswith(".wmx"):
        sys.exit(f"{args.weight}: .wmx artifacts are the JAX package's (wavemamba_tpu/deploy.py); "
                 f"the port serves its own {SUFFIX} artifacts "
                 "(python -m wavemamba_torch.scripts.export_model export)")
    set_parity_mode()
    dev = initialize(device=args.device)  # a process group under torchrun, else this device
    try:
        _serve(args, dev)
    finally:
        shutdown()


def _serve(args, dev):
    psnr = build_metric({"type": "psnr", "crop_border": 1, "test_y_channel": True})
    ssim = build_metric({"type": "ssim", "crop_border": 1, "test_y_channel": True})
    lpips_fn = None
    if args.gt and args.lpips_weights:  # before the model: a bad path fails at once
        lpips_fn = build_metric({"type": "lpips", "weights_path": args.lpips_weights},
                                device=dev)
    if args.compile_cache:
        enable_compilation_cache(args.compile_cache)
    artifact = model = None
    if args.weight.endswith(SUFFIX):
        # The artifact pads to its own exported buckets: the ladder is not used.
        artifact = load_exported(args.weight, device=dev)
    else:
        model = load_model(network_g_of(args), args.weight, dev)
    bytes_io = artifact is not None and artifact.io_dtype == "uint8"

    say = print if is_master() else (lambda *a, **k: None)  # rank 0 alone prints and writes
    ladder = None if args.no_bucket else BucketLadder(max_waste=args.bucket_waste)
    if is_master():
        os.makedirs(args.output, exist_ok=True)
    if os.path.isfile(args.input):
        paths = [args.input]
    else:
        paths = sorted(scandir(args.input, full_path=True))
    scores = {"psnr": [], "ssim": [], "lpips": []}
    with trace(args.trace) if args.trace else contextlib.nullcontext():
        for path in paths:
            name = os.path.basename(path)
            with annotate("wm.request", args=name):  # the parent of the image's spans
                img = imread(path)  # BGR uint8
                t0 = time.time()
                if artifact is not None:
                    batch = img[..., ::-1][None] if bytes_io else img2batch(img)  # RGB
                    out = artifact.tiled(batch) if args.tile else artifact(batch)
                else:
                    out = enhance(model, img2batch(img), ladder, tile=args.tile)
                line = f"{name}: {time.time() - t0:.3f}s"
                sr = out[0][..., ::-1] if bytes_io else batch2img(out)  # BGR uint8
                if args.gt:
                    gt_path = os.path.join(args.gt, name)
                    if os.path.exists(gt_path):
                        gt = imread(gt_path)
                        p, s = psnr(sr, gt), ssim(sr, gt)
                        scores["psnr"].append(p)
                        scores["ssim"].append(s)
                        line += f"  psnr {p:.4f}  ssim {s:.4f}"
                        if lpips_fn is not None:
                            lp = lpips_fn(sr, gt)
                            scores["lpips"].append(lp)
                            line += f"  lpips {lp:.4f}"
                say(line, flush=True)
                stem, ext = os.path.splitext(name)
                if is_master():
                    imwrite(sr, os.path.join(args.output, f"{stem}{args.suffix}{ext or '.png'}"))

    for k, v in scores.items():
        if v:
            say(f"avg {k}: {float(np.mean(v)):.4f}")
    if ladder is not None and artifact is None:
        say(f"buckets: {len(ladder.buckets)}")


if __name__ == "__main__":
    main()
