"""One rank of the port's multi-process checks over a torch process group.
The counterpart of `scripts/multiproc_worker.py` (the JAX package's
2-process mesh worker).

    python -m wavemamba_torch.scripts.multiproc_worker --init tcp://127.0.0.1:PORT \\
        --world 2 --rank R --out DIR [--device cuda|cpu] [--data DIR] [--checks all]
    torchrun --standalone --nproc_per_node=N -m wavemamba_torch.scripts.multiproc_worker \\
        --out DIR --checks scan

The ranks run on the card (`cuda:LOCAL_RANK`, NCCL) unless `--device cpu`
asks for the CPU (gloo). Each rank runs the checks that only execute with
several processes and
writes what it computed to `DIR/rank<R>.pkl` (numpy arrays and numbers; a
caller holds them against the JAX package and against one process):

  init      `parallel.initialize` (rank, world, device, `is_master`,
            `master_only`, the logger's rank-0 rule)
  sampler   `EnlargedSampler` rank sharding
  scan      `selective_scan_seq_sharded` on `scan_case(...)`'s inputs, the
            long-memory case, and an L that does not divide
  train     two data-parallel steps of the tiny config (wf=8, one block a
            level) from the weights in `--data`/tiny.pth, each rank on its
            2 rows of `train_batches()`: the averaged losses and the
            parameters after the steps; the eval step on the first global
            batch; and, as a planted fault that the caller's tolerance must
            catch, the same steps with each rank on its own gradients
  model     the small config (wf=16) with `scan_impl: seq_sharded` over
            the ranks
  tiles     `tiled_apply_mesh` of `tile_image()` with the tiny config
  val       validation sharded round-robin, the (sum, count) reduce
  cache     the device cache's slices of the global batch (`--data`/pngs)
  pipeline  `train_pipeline` on `--data`/train.yml (which ranks write)
  artifact  the tile programs of `--data`/mesh.wmt and mesh_u8.wmt (exported
            with `mesh_devices` = the world) served through
            `ExportedModel.tiled` on `artifact_image()` and its bytes

`--checks` names the ones to run (default: all but `pipeline`, which runs
where `--data` holds `train.yml`, and `artifact`). Prints "MULTIPROC WORKER
<rank> OK".
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np
import torch

SMALL = {"type": "WaveMamba", "in_chn": 3, "wf": 16, "n_l_blocks": [1, 1, 1],
         "n_h_blocks": [1, 1, 1], "ffn_scale": 2.0, "remat": False}
TINY = {"type": "WaveMamba", "in_chn": 3, "wf": 8, "n_l_blocks": [1, 1, 1],
        "n_h_blocks": [1, 1, 1], "ffn_scale": 2.0, "scan_chunk": 16, "scan_impl": "chunked"}
TRAIN_NET = {**TINY, "remat": False}
SCHEDULER = {"type": "CosineAnnealingRestartCyclicLR", "periods": [100, 100000],
             "restart_weights": [1, 1], "eta_mins": [0.0005, 0.0000001]}
TCFG = dict(lr=5e-4, weight_decay=1e-3, betas=(0.9, 0.99), scheduler=SCHEDULER,
            pixel_weight=1.0, fft_weight=0.1, ema_decay=0.999, grad_clip=0.5)
TRAIN_STEPS = 2
PER_RANK = 2  # images a rank takes a step
CHECKS = ("init", "sampler", "scan", "train", "model", "tiles", "val", "cache")


def scan_case(seed, b=2, k=2, length=256, d=8, n=4, slow=False):
    """Seeded selective-scan inputs (u, delta, A, Bs, Cs, D_skip,
    delta_bias) as float32 numpy, layouts of `ops/scan.py`; `slow` scales A
    by 0.01 (a decay near 1: long memory)."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    A = -np.exp(f(k, d, n) * 0.5)
    if slow:
        A = A * np.float32(0.01)
    return (f(b, k, length, d), f(b, k, length, d) * 0.5, A, f(b, k, length, n),
            f(b, k, length, n), f(k, d), f(k, d) * 0.1)


def train_batches(world, seed=10, size=32):
    """`TRAIN_STEPS` global batches of `PER_RANK` x `world` seeded low-light
    pairs (lq, gt), NHWC float32."""
    out = []
    for s in range(TRAIN_STEPS):
        rs = np.random.RandomState(seed + s)
        gt = rs.rand(PER_RANK * world, size, size, 3).astype(np.float32)
        lq = np.clip(gt * 0.12 + rs.randn(*gt.shape).astype(np.float32) * 0.01, 0, 1)
        out.append((lq.astype(np.float32), gt))
    return out


def model_images():
    """Inputs of the seq-sharded model check: 48x48 (every level's L even),
    and 40x56 (level 3's L = 35: padded to the ranks)."""
    rs = np.random.RandomState(0)
    return [rs.rand(1, 48, 48, 3).astype(np.float32), rs.rand(1, 40, 56, 3).astype(np.float32)]


def tile_image():
    return np.random.RandomState(1).rand(1, 96, 128, 3).astype(np.float32)


def artifact_image():
    """A frame larger than the artifact's buckets: (float32, its bytes)."""
    x = np.random.RandomState(3).rand(1, 40, 56, 3).astype(np.float32)
    return x, np.round(x * 255.0).astype(np.uint8)


def val_images(n=5, shape=(24, 24)):
    """n seeded validation pairs as `ThreadedLoader` batches of one."""
    rs = np.random.RandomState(0)
    for i in range(n):
        gt = rs.rand(1, *shape, 3).astype(np.float32)
        yield {"lq": gt * 0.3, "gt": gt, "lq_path": [f"im{i}.png"], "gt_path": [f"im{i}.png"]}


def val_opt(device):
    return {"name": "val", "model_type": "FeMaSRModel", "manual_seed": 0, "is_train": False,
            "device": device, "network_g": dict(TINY), "path": {}, "val": {"metrics": {
                "psnr": {"type": "psnr", "crop_border": 0, "test_y_channel": False},
                "ssim": {"type": "ssim", "crop_border": 0, "test_y_channel": False}}}}


def cache_opt(root):
    return {"phase": "train", "dataroot_gt": os.path.join(root, "gt"),
            "dataroot_lq": os.path.join(root, "input"), "io_backend": {"type": "disk"},
            "gt_size": 16, "scale": 1, "geometric_augs": True}


def run_checks(checks, device, data, rank, world):
    from wavemamba_torch import parallel
    from wavemamba_torch.parallel import mesh as pmesh

    mesh = parallel.make_mesh()
    assert pmesh.axis_size(mesh) == world and pmesh.axis_rank(mesh) == rank
    res = {"rank": rank, "world": world}

    if "init" in checks:
        from wavemamba_torch.utils.logger import get_root_logger

        assert parallel.get_dist_info() == (rank, world)
        assert parallel.is_master() == (rank == 0)
        res["device"] = str(device)
        res["master_only"] = parallel.master_only(lambda: rank)()
        res["logger_level"] = get_root_logger().level

    if "sampler" in checks:
        from wavemamba_torch.data import EnlargedSampler

        sampler = EnlargedSampler(10, world, rank, 2)
        sampler.set_epoch(3)
        res["sampler"] = list(iter(sampler))

    if "scan" in checks:
        from wavemamba_torch.parallel.seq_scan import selective_scan_seq_sharded

        def seq(args, chunk):
            t = [torch.from_numpy(a).to(device) for a in args]
            return selective_scan_seq_sharded(*t, mesh=mesh, chunk=chunk).cpu().numpy()

        res["scan"] = seq(scan_case(0), 16)
        res["scan_slow"] = seq(scan_case(1, b=1, k=1, length=512, d=4, n=2, slow=True), 32)
        try:
            seq(scan_case(2, length=255), 16)
            res["scan_ragged_error"] = None
        except ValueError as e:
            res["scan_ragged_error"] = str(e)

    if "train" in checks:
        from wavemamba_torch.checkpoint import load_network
        from wavemamba_torch.models import build_network
        from wavemamba_torch.train import trainer

        tcfg = trainer.TrainConfig(**TCFG)
        weights = load_network(os.path.join(data, "tiny.pth"), device="cpu")

        def train(step_mesh):
            """TRAIN_STEPS on this rank's rows; the gradients averaged over
            `step_mesh` (None: this rank's own, the planted fault)."""
            model = parallel.replicate(step_mesh, build_network(TRAIN_NET, weights, device=device))
            state = trainer.create_train_state(model, tcfg)
            step = trainer.make_train_step(tcfg, step_mesh)
            losses = []
            for lq, gt in train_batches(world):
                batch = parallel.shard_batch(mesh, {"lq": torch.from_numpy(lq).to(device),
                                                    "gt": torch.from_numpy(gt).to(device)})
                state, metrics = step(state, batch["lq"], batch["gt"])
                losses.append({k: float(v)
                               for k, v in trainer.mean_metrics(metrics, mesh).items()})
            return model, state, losses

        model, state, res["train_losses"] = train(mesh)
        res["train_params"] = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        res["train_ema"] = {k: v.cpu().numpy() for k, v in state.ema.items()}
        # the eval step takes the global batch and gives every rank all of it
        lq = torch.from_numpy(train_batches(world)[0][0]).to(device)
        res["eval"] = trainer.make_eval_step(mesh)(model, lq).cpu().numpy()
        fault, _, _ = train(None)
        res["train_params_unaveraged"] = {k: v.detach().cpu().numpy()
                                          for k, v in fault.state_dict().items()}

    if "model" in checks:
        from wavemamba_torch.models import init_network, wavemamba_apply

        seq_net = {**SMALL, "scan_impl": "seq_sharded", "scan_chunk": 8, "scan_mesh": mesh}
        model = init_network(seq_net, torch.Generator().manual_seed(0), device=device, train=False)
        res["model"] = [wavemamba_apply(model, torch.from_numpy(x).to(device)).cpu().numpy()
                        for x in model_images()]

    if "tiles" in checks:
        from wavemamba_torch.checkpoint import load_network
        from wavemamba_torch.models import build_network, wavemamba_apply
        from wavemamba_torch.models.tiling import tiled_apply_mesh

        model = build_network(TINY, load_network(os.path.join(data, "tiny.pth"), device="cpu"),
                              device=device)
        calls = []

        def counted(m, x):
            calls.append(tuple(x.shape))
            return wavemamba_apply(m, x)

        res["tiles"] = tiled_apply_mesh(counted, model, tile_image(), mesh, tile_size=48,
                                        tile_pad=8)
        res["tile_calls"] = calls

    if "val" in checks:
        from wavemamba_torch.runner import build_model

        model = build_model(val_opt(str(device)), mesh)
        res["val"], _ = model.validation(val_images(), current_iter=1)

    if "cache" in checks:
        from wavemamba_torch.data import DeviceCachedLoader, EnlargedSampler
        from wavemamba_torch.data.paired_image_dataset import PairedImageDataset

        ds = PairedImageDataset(cache_opt(os.path.join(data, "pngs")))
        loader = DeviceCachedLoader(ds, 2 * world, sampler=EnlargedSampler(len(ds.paths), 1, 0, 2),
                                    seed=7, device=device, mesh=mesh)
        loader.set_epoch(1)
        res["cache"] = [{"lq": b["lq"].cpu().numpy(), "gt": b["gt"].cpu().numpy(),
                         "lq_path": b["lq_path"]} for b in loader]

    if "artifact" in checks:
        from wavemamba_torch.deploy import load_exported

        for name, x in zip(("mesh", "mesh_u8"), artifact_image()):
            model = load_exported(os.path.join(data, f"{name}.wmt"), device=device)
            res[f"artifact_{name}"] = model.tiled(x)
            res[f"artifact_{name}_replays"] = model.runners["tile"].replays

    if "pipeline" in checks:
        from wavemamba_torch import runner
        from wavemamba_torch.pipelines.train import train_pipeline

        writes, save = [], runner.save_network

        def counted_save(*args, **kw):
            writes.append(args[2])
            return save(*args, **kw)

        runner.save_network = counted_save
        try:
            model = train_pipeline(data, ["-opt", os.path.join(data, "train.yml"),
                                          "--device", str(device)])
        finally:
            runner.save_network = save
        res["pipeline_writes"] = writes
        res["pipeline_params"] = {k: v.detach().cpu().numpy()
                                  for k, v in model.model.state_dict().items()}
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--init", default=None, help="tcp://host:port (torchrun: its environment)")
    parser.add_argument("--world", type=int, default=None)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="'cpu' runs the ranks on the CPU")
    parser.add_argument("--data", default=None, help="inputs the caller wrote (weights, PNGs, yml)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--checks", default="all", help="comma-separated, or 'all'")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)

    from wavemamba_torch import parallel
    from wavemamba_torch.parallel.dist import shutdown

    device = parallel.initialize(args.init, args.world, args.rank, device=args.device)
    rank, world = parallel.get_dist_info()
    checks = list(CHECKS) if args.checks == "all" else args.checks.split(",")
    if args.checks == "all" and args.data and os.path.exists(os.path.join(args.data, "train.yml")):
        checks.append("pipeline")
    try:
        res = run_checks(checks, device, args.data, rank, world)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        parallel.barrier()
    finally:
        shutdown()
    print(f"MULTIPROC WORKER {rank} OK", flush=True)


if __name__ == "__main__":
    sys.exit(main())
