"""Model runner: the train / eval logic between the yml options and the
trainer. The counterpart of `wavemamba_tpu/runner.py`.

  * builds the network, the train configuration and the train state from the
    options (`network_g`, `train`, `path.pretrain_network_g`)
  * feeds batches to the train step (`train/trainer.py`)
  * validation with the metrics the options declare, best-metric tracking
  * checkpoint save / resume through `checkpoint.py`

One process drives one device: `opt['device']` ('cuda' unless the options
say 'cpu'; under a process group the rank's device, `parallel.initialize`).
With a mesh (`parallel.make_mesh()`) the model is built from the same seed
on every rank and replicated from rank 0, after `resume()` too; the train
step averages the gradients over the mesh; rank 0 alone writes checkpoints,
and the other ranks wait for it before they read one. Validation shards the
images round-robin by rank and reduces each metric's (sum, count) over the
group. Evaluation runs the EMA weights when EMA is on, through
`torch.func.functional_call`, so the trained weights stay where they are.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from wavemamba_torch.checkpoint import (
    find_resume_state,
    load_network,
    restore_training_state,
    save_network,
    save_training_state,
)
from wavemamba_torch.device import resolve_device
from wavemamba_torch.metrics import METRIC_DIRECTION, build_metric
from wavemamba_torch.models import init_network
from wavemamba_torch.models.buckets import BucketLadder
from wavemamba_torch.models.tiling import tiled_apply
from wavemamba_torch.parallel.dist import barrier, get_dist_info, is_master
from wavemamba_torch.parallel.mesh import replicate, world_sum
from wavemamba_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_lr,
    make_train_step,
    mean_metrics,
)
from wavemamba_torch.utils.img_util import batch2img, imwrite
from wavemamba_torch.utils.logger import get_root_logger


def train_config_from_opt(opt: dict, loss_mode: str = "l1fft") -> TrainConfig:
    t = opt.get("train", {})
    optim = t.get("optim_g", {})
    fft_w = t["fft_opt"].get("loss_weight", 0.1) if t.get("fft_opt") else 0.0
    return TrainConfig(
        loss_mode=loss_mode,
        lr=optim.get("lr", 5e-4),
        weight_decay=optim.get("weight_decay", 1e-3),
        betas=tuple(optim.get("betas", (0.9, 0.99))),
        scheduler=dict(t.get("scheduler", {})) or None,
        pixel_weight=(t.get("pixel_opt") or {}).get("loss_weight", 1.0),
        fft_weight=fft_w,
        ema_decay=t.get("ema_decay", 0.0),
        grad_clip=t.get("grad_clip"),
        warmup_iter=t.get("warmup_iter", -1),
    )


def _world():
    """(number of processes, this one's rank): the process group's, else one
    process."""
    rank, world = get_dist_info()
    return world, rank


def _reflect_pad(x, H, W):
    """(B, h, w, C) tensor -> (B, H, W, C), reflect-padded bottom/right on its
    device; on the host with numpy where the pad is wider than the image
    (numpy re-reflects, `F.pad` raises)."""
    h, w = x.shape[1:3]
    ph, pw = H - h, W - w
    if ph == 0 and pw == 0:
        return x
    if ph < h and pw < w:
        return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
    padded = np.pad(x.cpu().numpy(), ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return torch.from_numpy(padded).to(x.device)


class RestorationModel:
    """The `model_type: FeMaSRModel` runner."""

    def __init__(self, opt: dict, mesh=None, loss_mode: str = "l1fft"):
        self.opt = opt
        self.mesh = mesh
        self.logger = get_root_logger()
        self.device = resolve_device(opt.get("device", "cuda"))
        self.is_train = opt.get("is_train", False)
        self.loss_mode = loss_mode

        seed = opt.get("manual_seed", 0) or 0
        self.model = init_network(opt["network_g"], torch.Generator().manual_seed(seed),
                                  device=self.device, train=self.is_train)
        self.cfg = self.model.cfg
        pretrain = opt.get("path", {}).get("pretrain_network_g")
        if pretrain:
            self.logger.info(f"Loading net_g from {pretrain}")
            self.model.load_state_dict(load_network(pretrain, device=self.device), strict=True)
        replicate(mesh, self.model)

        self.state = None
        self.train_step = None
        if self.is_train:
            self.tcfg = train_config_from_opt(opt, loss_mode=loss_mode)
            self.state = create_train_state(self.model, self.tcfg)
            self.train_step = make_train_step(self.tcfg, mesh)
            self._lr = make_lr(self.tcfg)
        else:
            self.model.eval()

        # `val: bucket: true` pads a mixed-size folder up to shared x128
        # buckets. Off by default: the pad perturbs borders at the 1e-3 scale
        # (the scan is global), and validation during training keeps the
        # exact per-image padding.
        self._bucket_ladder = BucketLadder() if opt.get("val", {}).get("bucket") else None
        self.best_metric_results = {}

    # ------------------------------------------------------------------ train
    def _to_device(self, v):
        return (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(self.device)

    def optimize_parameters(self, batch):
        """One train step on {'lq', 'gt'} (numpy arrays or tensors on the
        device, NHWC, float32 or uint8); returns the metrics, tensors on the
        device (no host sync)."""
        self.state, metrics = self.train_step(self.state, self._to_device(batch["lq"]),
                                              self._to_device(batch["gt"]))
        return metrics

    def reduce_metrics(self, metrics):
        """A step's metrics averaged over the mesh: the global batch's (every
        rank must call it at the same step)."""
        return mean_metrics(metrics, self.mesh)

    def current_params(self, use_ema=True):
        """{name: tensor}: the EMA weights when EMA is on and asked for, else
        the model's."""
        if use_ema and self.state is not None and self.state.ema is not None:
            return self.state.ema
        return dict(self.model.named_parameters())

    def current_lr(self, step=None):
        s = self.state.step if step is None else step
        return float(self._lr(s)) if callable(self._lr) else float(self._lr)

    # ------------------------------------------------------------------- eval
    def _forward(self, x):
        """The network on x (B, H, W, 3) on the device, NHWC in and out, with
        `current_params()`, in eval mode."""
        was_training = self.model.training
        self.model.eval()
        try:
            out = torch.func.functional_call(self.model, self.current_params(),
                                             (x.permute(0, 3, 1, 2),))
        finally:
            self.model.train(was_training)
        if isinstance(out, (tuple, list)):  # two-output nets (UHDModel): the full-size output
            out = out[0]
        return out.permute(0, 2, 3, 1)

    @torch.no_grad()
    def test(self, lq, pad_multiple=8, tile=None):
        """Whole-image (or tiled) restoration. lq: (1, H, W, 3) float32 RGB, a
        numpy array or a tensor. Returns a numpy array of the same shape.

        Tiled (`models/tiling.py`) when `tile` is given, a dict with
        `tile_size` (240) and `tile_pad` (16), or for a frame of 8000 x 8000
        pixels or more, as the JAX runner does."""
        h, w = lq.shape[1:3]
        if tile or h * w >= 8000 * 8000:
            tile = tile or {}
            lq_np = lq.cpu().numpy() if isinstance(lq, torch.Tensor) else np.asarray(lq)
            return tiled_apply(
                lambda t: self._forward(self._to_device(t).float()).cpu().numpy(), lq_np,
                tile_size=tile.get("tile_size", 240), tile_pad=tile.get("tile_pad", 16),
                pad_multiple=pad_multiple)
        x = self._to_device(lq).float()
        if self._bucket_ladder is not None:
            H, W = self._bucket_ladder.shape_for(h, w)
        else:
            H, W = h + (-h) % pad_multiple, w + (-w) % pad_multiple
        return self._forward(_reflect_pad(x, H, W))[:, :h, :w].cpu().numpy()

    def validation(self, dataloader, current_iter, save_img=False, num_shards=None,
                   shard_id=None):
        """Validation over `dataloader` (batches of one image), round-robin
        sharded: this call evaluates the images i with i % num_shards ==
        shard_id (by default the process's rank among the process group's
        processes, one shard in a single process). Returns ({metric: average},
        improved): whether the key metric beat its best so far."""
        opt_val = self.opt.get("val", {})
        metric_opts = opt_val.get("metrics") or {}
        world, rank = _world()
        num_shards = world if num_shards is None else num_shards
        shard_id = rank if shard_id is None else shard_id
        key_metric = opt_val.get("key_metric")
        metrics = {}
        for name, mopt in metric_opts.items():
            try:
                metrics[name] = build_metric(dict(mopt), device=self.device)
            except (ValueError, KeyError, NotImplementedError) as e:
                if name == key_metric:
                    # Best-model tracking hinges on this metric: a warning
                    # would silently turn the best checkpoint's selection off.
                    raise ValueError(f"key metric {name!r} failed to build: {e}") from e
                self.logger.warning(f"metric {name} skipped: {e}")
        results = {name: [] for name in metrics}
        t0 = time.time()
        for i, batch in enumerate(dataloader):
            if i % num_shards != shard_id:
                continue
            gt = batch.get("gt")
            sr_img = batch2img(self.test(batch["lq"]))
            if save_img:
                img_name = os.path.splitext(os.path.basename(batch["lq_path"][0]))[0]
                imwrite(sr_img, os.path.join(self.opt["path"]["visualization"],
                                             f"{img_name}_{current_iter}.png"))
            if gt is not None:
                gt_img = batch2img(gt.cpu().numpy() if isinstance(gt, torch.Tensor) else gt)
                for name, fn in metrics.items():
                    results[name].append(fn(sr_img, gt_img))
        avg = self._aggregate_val_results(results, num_shards)
        self.logger.info(f"Validation @ iter {current_iter} ({time.time() - t0:.1f}s): "
                         + ", ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
        improved = False
        if key_metric and key_metric in avg:
            higher_better = METRIC_DIRECTION.get(key_metric, True)
            best = self.best_metric_results.get(key_metric)
            if best is None or (avg[key_metric] > best if higher_better else avg[key_metric] < best):
                self.best_metric_results[key_metric] = avg[key_metric]
                improved = True
        return avg, improved

    @staticmethod
    def _aggregate_val_results(results: dict, num_shards: int) -> dict:
        """This rank's per-metric value lists -> the global averages. One
        shard, or one process: a plain mean. Several processes: each
        metric's (sum, count) in float64, summed over the group (JAX's
        `process_allgather` and sum), so every rank returns the same
        averages."""
        if num_shards <= 1 or _world()[0] == 1:
            return {name: float(np.mean(v)) for name, v in results.items() if v}
        names = sorted(results)
        local = [[float(np.sum(results[n])), float(len(results[n]))] for n in names]
        totals = world_sum(local)
        return {n: float(totals[i, 0] / totals[i, 1]) for i, n in enumerate(names)
                if totals[i, 1] > 0}

    # ------------------------------------------------------------ checkpoints
    def save(self, current_iter):
        """Rank 0 writes (the ranks hold the same state); every rank returns
        when the files are there."""
        if is_master():
            models_dir = self.opt["path"]["models"]
            save_network(self.model, models_dir, "net_g", current_iter)
            if self.state is not None and self.state.ema is not None:
                save_network(self.state.ema, models_dir, "net_g_ema", current_iter)
            if self.state is not None:
                save_training_state(self.state, self.opt["path"]["training_states"], current_iter)
        barrier()

    def save_best(self):
        if is_master():
            save_network(self.model, self.opt["path"]["models"], "net_g_best", -1)
        barrier()

    def resume(self):
        """Resume from the training state of the highest iteration; returns
        that iteration, 0 when there is none. Every rank waits until rank 0
        has written, reads the same state, and takes rank 0's."""
        barrier()
        path = find_resume_state(self.opt["path"]["training_states"])
        if path is None:
            return 0
        self.logger.info(f"Resuming from {path}")
        self.state = restore_training_state(path, self.state)
        replicate(self.mesh, [self.state.model, self.state.optimizer, self.state.ema])
        return self.state.step


def build_model(opt: dict, mesh=None):
    """`model_type` dispatch: FeMaSRModel / RestorationModel train with L1 +
    FFT; UHDModel with UHDFour's composite loss, which needs a network whose
    forward returns (out, out8): a single-output network raises at the first
    train step. `mesh`: see the module docstring."""
    mtype = opt.get("model_type", "FeMaSRModel")
    if mtype in ("FeMaSRModel", "RestorationModel"):
        return RestorationModel(opt, mesh=mesh)
    if mtype == "UHDModel":
        return RestorationModel(opt, mesh=mesh, loss_mode="uhd")
    raise KeyError(f"Unknown model_type {mtype!r}")
