"""Build and serve deployment artifacts (`wavemamba_torch/deploy.py`). The
counterpart of `scripts/export_model.py`.

Export a checkpoint to a self-contained ``.wmt`` archive (programs are
traced on the CPU, so a build host needs no card)::

    python -m wavemamba_torch.scripts.export_model export \
        -w ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth --shapes 1152x1920 768x1280 \
        -o wavemamba_1080p.wmt --target cuda --allow_custom_calls

Serve a folder from the artifact alone (the model source is not imported;
`deploy.py` and K1's op are the dependency)::

    python -m wavemamba_torch.scripts.export_model run -a wavemamba_1080p.wmt \
        -i datasets/val/input -o results/served [--compile_cache DIR]

`run` serves on the card unless `--device cpu` is given; each program runs as
one CUDA graph there, captured at its first frame.
"""

from __future__ import annotations

import argparse
import os
import time


def _parse_shape(s):
    h, _, w = s.partition("x")
    return (int(h), int(w))


def cmd_export(args):
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.deploy import export_model
    from wavemamba_torch.models.wavemamba import WaveMambaConfig

    mk = WaveMambaConfig.fast if args.fast else WaveMambaConfig
    if args.fast and args.target == "cuda":
        # The card's preset whatever the build host: the port's fast() is
        # fast_tpu() on every device, named here as the JAX CLI names it.
        mk = WaveMambaConfig.fast_tpu
    cfg = mk(wf=args.wf, n_l_blocks=tuple(args.n_l_blocks), n_h_blocks=tuple(args.n_h_blocks))
    state_dict = load_network(args.weight, device="cpu")
    shapes = [_parse_shape(s) for s in args.shapes]
    tile = None
    if args.tile:
        tile = {"size": args.tile, "pad": args.tile_pad, "batch": args.tile_batch}
    t0 = time.perf_counter()
    manifest = export_model(
        state_dict, cfg, shapes, args.out, batch=args.batch, platforms=args.platforms,
        allow_custom_calls=args.allow_custom_calls, tile=tile, mesh_devices=args.mesh_devices,
        io_dtype=args.io)
    size = os.path.getsize(args.out)
    trace_s, save_s = (sum(manifest["build"][k].values()) for k in ("trace_s", "save_s"))
    print(f"wrote {args.out} ({size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f}s "
          f"(trace {trace_s:.1f}s, save {save_s:.1f}s): "
          f"{len(shapes)} program(s){' + tile' if tile else ''} for {manifest['platforms']}, "
          f"{manifest['param_bytes'] / 1e6:.1f} MB weights")


def cmd_run(args):
    from wavemamba_torch.deploy import load_exported
    from wavemamba_torch.utils.img_util import batch2img, img2batch, imread, imwrite
    from wavemamba_torch.utils.misc import scandir

    model = load_exported(args.artifact, compile_cache=args.compile_cache, device=args.device)
    print(f"artifact: shapes {model.shapes}, platforms {model.manifest['platforms']}")
    os.makedirs(args.output, exist_ok=True)
    paths = ([args.input] if os.path.isfile(args.input)
             else sorted(scandir(args.input, full_path=True)))

    def _prep(path):
        img = imread(path)  # BGR uint8
        if model.io_dtype == "uint8":
            # Bytes in, bytes out: BGR->RGB view only; the float conversion
            # and the save path's quantization both run in the program.
            return img[..., ::-1][None]
        return img2batch(img)

    def _save(path, out):
        sr = out[0][..., ::-1] if model.io_dtype == "uint8" else batch2img(out)
        imwrite(sr, os.path.join(args.output, os.path.basename(path)))

    if args.tiled:
        for path in paths:
            t0 = time.time()
            _save(path, model.tiled(_prep(path)))
            print(f"{os.path.basename(path)}: {time.time() - t0:.3f}s", flush=True)
        return
    # Whole-frame serving is pipelined one frame deep: frame i+1 is decoded
    # and dispatched before frame i's result is fetched and encoded, so the
    # device's work overlaps the host's (ExportedModel.dispatch).
    pending = None  # (path, handle, t0)
    for path in paths + [None]:
        nxt = None
        if path is not None:
            t0 = time.time()
            nxt = (path, model.dispatch(_prep(path)), t0)
        if pending is not None:
            p, handle, t0 = pending
            _save(p, handle.fetch())
            print(f"{os.path.basename(p)}: {time.time() - t0:.3f}s", flush=True)
        pending = nxt


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("export", help="serialize a checkpoint to .wmt")
    p.add_argument("-w", "--weight", required=True, help=".pth checkpoint")
    p.add_argument("-o", "--out", required=True, help="output .wmt path")
    p.add_argument("--shapes", nargs="+", required=True,
                   help="static input shapes, e.g. 1152x1920 (pad-multiple 128 like the reference)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--fast", action="store_true",
                   help="bf16 preset (the scan becomes the portable 'par' scan unless "
                        "--allow_custom_calls)")
    p.add_argument("--allow_custom_calls", action="store_true",
                   help="keep kernel K1 as its registered op (a card artifact unless "
                        "--platforms lists cpu)")
    p.add_argument("--platforms", nargs="+", choices=["cpu", "cuda"], default=None,
                   help="devices the artifact serves on (default: cpu cuda; cuda with "
                        "--allow_custom_calls)")
    p.add_argument("--tile", type=int, default=0,
                   help="also export a fixed-shape tile program (frames larger than every "
                        "bucket; 0 = whole-frame programs only)")
    p.add_argument("--tile_pad", type=int, default=16)
    p.add_argument("--tile_batch", type=int, default=8)
    p.add_argument("--target", choices=["auto", "cuda"], default="auto",
                   help="with --fast: 'cuda' builds the card's preset (fast_tpu) on any build "
                        "host; in the port 'auto' builds the same")
    p.add_argument("--io", choices=["float32", "uint8"], default="float32",
                   help="uint8 puts the byte<->float conversion in the program, quantized as "
                        "the PNG save path")
    p.add_argument("--mesh_devices", type=int, default=1,
                   help="shard the tile program over this many ranks (needs --tile; served "
                        "under torchrun --nproc_per_node=N by `inference --tile`)")
    p.add_argument("--wf", type=int, default=32)
    p.add_argument("--n_l_blocks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--n_h_blocks", type=int, nargs="+", default=[1, 1, 2])
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("run", help="enhance a folder from a .wmt artifact")
    p.add_argument("-a", "--artifact", required=True)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="results/served")
    p.add_argument("--tiled", action="store_true",
                   help="use the artifact's tile program (frames larger than every bucket)")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="directory where the kernels are built and looked up: the first "
                        "process builds K1 there, every later one loads it")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_run)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
