"""The overhead of the sharded tile path on 1, 2 and 4 ranks. The
counterpart of `scripts/multichip_scaling.py`.

    python -m wavemamba_torch.scripts.multichip_scaling [--ranks 1 2 4] [--device cuda|cpu]

A 320x512 frame in 64-px tiles with 8 px of context (a 5x8 grid, the 40
tiles of an 8K frame's structure) goes through `tiled_apply_mesh` with the
small config (wf=16, one block a level) on n ranks, each a process of its
own in one process group. For each n it prints the tile batch, the calls a
rank makes, the padding tiles, the seconds of the first call and of a later
call, the collectives a call runs (one: the gather of the shares), and the
largest difference from one process's `tiled_apply` on the same device,
which must stay under 3e-5 (float32: no TF32 on the card).

On the card (the default) rank r runs on `cuda:(r mod the cards)`, over
NCCL where every rank has a card of its own and over gloo where ranks share
one; `--device cpu` runs gloo ranks on the CPU. Ranks that share a card or
the CPU's cores measure the sharded path's overhead (padding, the gather,
the host's work a call), not how the path scales over cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from wavemamba_torch.inference import set_parity_mode

# the collectives that `tiled_apply_mesh` may run, counted
_COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "broadcast")
NET = {"type": "WaveMamba", "in_chn": 3, "wf": 16, "n_l_blocks": [1, 1, 1],
       "n_h_blocks": [1, 1, 1], "ffn_scale": 2.0, "scan_chunk": 64, "scan_impl": "chunked"}
TILE, PAD, N_TILES = 64, 8, 40
ATOL = 3e-5


def _model(device):
    from wavemamba_torch.models import init_network

    return init_network(NET, torch.Generator().manual_seed(0), device=device, train=False)


def _image():
    return np.random.RandomState(0).rand(1, 320, 512, 3).astype(np.float32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_device(device, rank, world):
    """(device, backend) of a rank: see the module docstring."""
    if device == "cpu":
        return "cpu", "gloo"
    cards = torch.cuda.device_count()
    return f"cuda:{rank % max(cards, 1)}", "nccl" if world <= cards else "gloo"


def rank_main(args):
    """One rank: the sharded tiles, timed; rank 0 writes the row."""
    import torch.distributed as dist

    from wavemamba_torch import parallel
    from wavemamba_torch.models import wavemamba_apply
    from wavemamba_torch.models.tiling import tiled_apply_mesh
    from wavemamba_torch.parallel.dist import shutdown
    from wavemamba_torch.parallel.mesh import axis_size

    torch.set_num_threads(1)
    set_parity_mode()
    name, backend = _rank_device(args.device, args.rank, args.world)
    device = parallel.initialize(args.init, args.world, args.rank, backend=backend, device=name)
    mesh = parallel.make_mesh()
    model = parallel.replicate(mesh, _model(device))
    calls, collectives = [], []
    counted = {k: getattr(dist, k) for k in _COLLECTIVES}

    def counter(fn):
        def call(*a, **k):
            collectives.append(1)
            return fn(*a, **k)
        return call

    def timed(m, x):
        _sync(device)
        t0 = time.perf_counter()
        y = wavemamba_apply(m, x)
        _sync(device)
        calls.append((x.shape[0], time.perf_counter() - t0))
        return y

    for k, fn in counted.items():
        setattr(dist, k, counter(fn))
    try:
        t0 = time.perf_counter()
        out = tiled_apply_mesh(timed, model, _image(), mesh, tile_size=TILE, tile_pad=PAD)
        total = time.perf_counter() - t0
    finally:
        for k, fn in counted.items():
            setattr(dist, k, fn)
    n = axis_size(mesh)
    tile_batch = calls[0][0] * n  # tiled_apply_mesh's choice, as the calls show it
    secs = [c[1] for c in calls]
    if args.rank == 0:
        np.save(args.out + ".npy", out)
        with open(args.out, "w") as f:
            json.dump({"ranks": n, "device": str(device), "backend": dist.get_backend(),
                       "tile_batch": tile_batch, "calls_a_rank": len(calls),
                       "pad_tiles": len(calls) * tile_batch - N_TILES,
                       "tiles_a_call_a_rank": calls[0][0], "first_call_s": secs[0],
                       "later_call_s": float(np.median(secs[1:])) if len(secs) > 1 else None,
                       "collectives_a_call": len(collectives) / len(calls), "total_s": total}, f)
    parallel.barrier()
    shutdown()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--init", help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.init:
        return rank_main(args)

    from wavemamba_torch.device import resolve_device
    from wavemamba_torch.models import wavemamba_apply
    from wavemamba_torch.models.tiling import tiled_apply
    from wavemamba_torch.parallel.dist import local_init_method

    torch.set_num_threads(1)
    set_parity_mode()
    model = _model(resolve_device(args.device))
    device = next(model.parameters()).device
    ref = tiled_apply(lambda t: wavemamba_apply(model, torch.from_numpy(t).to(device)).cpu().numpy(),
                      _image(), tile_size=TILE, tile_pad=PAD)
    del model
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    print("ranks that share a card or the CPU's cores: the wall times are the sharded path's "
          "overhead, not a scaling figure", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.ranks:
            out = os.path.join(tmp, f"ranks{n}.json")
            init = local_init_method()
            procs = [subprocess.Popen([sys.executable, "-m", "wavemamba_torch.scripts.multichip_scaling",
                                       "--init", init, "--world", str(n), "--rank", str(r),
                                       "--device", args.device, "--out", out], env=env)
                     for r in range(n)]
            codes = [p.wait(timeout=900) for p in procs]
            if any(codes):
                sys.exit(f"multichip_scaling: a rank of {n} exited {codes}")
            with open(out) as f:
                row = json.load(f)
            row["max_abs_vs_one_process"] = float(np.abs(np.load(out + ".npy") - ref).max())
            print(json.dumps(row), flush=True)
            if row["max_abs_vs_one_process"] >= ATOL:
                sys.exit(f"multichip_scaling: {n} ranks differ from one process by "
                         f"{row['max_abs_vs_one_process']}")
    print("MULTICHIP SCALING OK")


if __name__ == "__main__":
    main()
