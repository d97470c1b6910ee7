"""Training pipeline. The counterpart of `wavemamba_tpu/pipelines/train.py`.

    python -m wavemamba_torch.pipelines.train -opt options/train_wavemamba_uhdll.yml
    torchrun --standalone --nproc_per_node=N -m wavemamba_torch.pipelines.train -opt <yml>

One process drives one device: the card, or the CPU with `--device cpu` (the
only way onto it; without the flag a host without CUDA raises). Under
torchrun the processes form a group (`parallel.initialize`: NCCL on the
cards, gloo with `--device cpu`), rank r on `cuda:LOCAL_RANK`: each loads
`batch_size_per_gpu` images of its shard of the sampler, so the global batch
is `batch_size_per_gpu` x ranks, the gradients are averaged over the ranks,
the logged losses are the global batch's, rank 0 alone makes the experiment
directory, logs to the file and writes checkpoints. One process without
torchrun is the one-card run. Losses stay on the device; the host reads them
at `print_freq` only. Checkpoints are `.pth` and `.state` files
(`checkpoint.py`); `--auto_resume` continues from the highest saved state.
With `cache_on_device: true` the train set is staged on the device once
(`data/device_cache.py`, on every rank) and its batches are drawn there.
"""

from __future__ import annotations

import os
import time

import torch

from wavemamba_torch.checkpoint import find_resume_state
from wavemamba_torch.data import (
    DeviceCachedLoader,
    EnlargedSampler,
    ThreadedLoader,
    build_dataset,
    device_prefetch,
)
from wavemamba_torch.parallel import barrier, get_dist_info, initialize, is_master, make_mesh
from wavemamba_torch.parallel.dist import broadcast_object, shutdown
from wavemamba_torch.parallel.mesh import axis_size
from wavemamba_torch.runner import build_model
from wavemamba_torch.utils.logger import (
    AvgTimer,
    MessageLogger,
    get_env_info,
    get_root_logger,
    init_tb_logger,
)
from wavemamba_torch.utils.misc import make_exp_dirs, set_random_seed
from wavemamba_torch.utils.options import copy_opt_file, dict2str, parse_options


def create_train_val_dataloader(opt, logger, mesh=None):
    train_loader, val_loader = None, None
    total_iters = int(opt["train"]["total_iter"])
    rank, world = get_dist_info()
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_set = build_dataset(dataset_opt)
            ratio = dataset_opt.get("dataset_enlarge_ratio", 1)
            batch = dataset_opt.get("batch_size_per_gpu", 1)
            global_batch = batch * axis_size(mesh)
            if dataset_opt.get("cache_on_device"):
                # The device-resident dataset (data/device_cache.py): every rank
                # draws the global batch from an unsharded sampler and keeps its
                # rows. A dataset that does not qualify (shapes, mean/std, the
                # budget) takes the threaded host loader, as in the JAX package.
                # Any other error propagates.
                try:
                    train_loader = DeviceCachedLoader(
                        train_set, batch_size=global_batch,
                        sampler=EnlargedSampler(len(train_set), 1, 0, ratio),
                        seed=opt.get("manual_seed"), device=opt.get("device", "cuda"),
                        budget_gb=dataset_opt.get("device_cache_budget_gb", 8.0), mesh=mesh)
                    logger.info(f"cache_on_device: dataset staged on {train_loader.device} "
                                f"({train_loader.nbytes / 2**20:.0f} MiB); per-step host work is "
                                "index RNG only")
                except ValueError as e:
                    logger.warning(f"cache_on_device unavailable ({e}); using host loader")
            if train_loader is None:
                # each rank loads its shard of the sampler, as the reference's DDP ranks do
                sampler = EnlargedSampler(len(train_set), world, rank, ratio)
                train_loader = ThreadedLoader(train_set, batch_size=batch, sampler=sampler,
                                              num_workers=dataset_opt.get("num_worker_per_gpu", 4),
                                              drop_last=True, seed=opt.get("manual_seed"))
            iters_per_epoch = len(train_loader)
            if iters_per_epoch == 0:
                raise ValueError(
                    f"Train loader is empty: dataset of {len(train_set)} images with batch "
                    f"{batch} (drop_last) yields no batches: raise dataset_enlarge_ratio or "
                    "lower the batch.")
            total_epochs = -(-total_iters // iters_per_epoch)
            logger.info(f"Training statistics: images {len(train_set)}, global batch "
                        f"{global_batch} ({axis_size(mesh)} process(es) x {batch}), "
                        f"iters/epoch {iters_per_epoch}, total epochs {total_epochs}, "
                        f"total iters {total_iters}")
        elif phase.startswith("val"):
            val_set = build_dataset(dataset_opt)
            val_loader = ThreadedLoader(val_set, batch_size=1, num_workers=2)
            logger.info(f"Validation images: {len(val_set)}")
    return train_loader, val_loader, total_iters


def train_pipeline(root_path, args=None):
    opt, parsed = parse_options(root_path, is_train=True, args=args)
    device = initialize(device=opt["device"])  # a process group under torchrun
    opt["device"] = str(device)
    mesh = make_mesh()
    # every rank takes rank 0's seed (a yml without one draws it per process)
    opt["manual_seed"] = broadcast_object(opt["manual_seed"])
    set_random_seed(opt["manual_seed"])

    # An existing experiment directory is archived only on a fresh start; with
    # --auto_resume and a saved training state the run resumes in place. Rank 0
    # makes the directories and the log file; the others wait for them.
    resuming = bool(opt.get("auto_resume")
                    and find_resume_state(opt["path"]["training_states"]) is not None)
    barrier()
    if is_master():
        make_exp_dirs(opt, archive=not resuming)
        copy_opt_file(parsed.opt, opt["path"]["experiments_root"])
    barrier()
    log_file = os.path.join(opt["path"]["log"], f"train_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    rank, world = get_dist_info()
    if mesh is not None:
        logger.info(f"process group: {torch.distributed.get_backend()}, {world} rank(s), "
                    f"rank {rank} on {device}")
    tb_logger = None
    if (is_master() and opt.get("logger", {}).get("use_tb_logger")
            and "debug" not in opt["name"]):
        try:
            tb_logger = init_tb_logger(os.path.join(opt["path"]["log"], "tb_logger"))
        except Exception as e:
            logger.warning(f"tensorboard unavailable: {e}")

    train_loader, val_loader, total_iters = create_train_val_dataloader(opt, logger, mesh)
    model = build_model(opt, mesh)

    start_iter = model.resume() if opt.get("auto_resume") else 0
    msg_logger = MessageLogger(opt, start_iter + 1, tb_logger)
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    print_freq = opt["logger"]["print_freq"]
    save_freq = opt["logger"]["save_checkpoint_freq"]
    val_freq = opt.get("val", {}).get("val_freq")
    save_img = opt.get("val", {}).get("save_img", False)

    current_iter = start_iter
    # On resume, restart at the epoch the saved iteration falls in.
    epoch = start_iter // max(len(train_loader), 1)
    logger.info(f"Start training from iter {current_iter}")
    start = time.time()
    # A device-resident loader's batches are on the device already: the host
    # staging thread would only add a queue hop.
    if getattr(train_loader, "yields_device_batches", False):
        prefetch = iter
    else:
        prefetch = lambda loader: device_prefetch(loader, device)  # noqa: E731
    while current_iter < total_iters:
        train_loader.set_epoch(epoch)
        for batch in prefetch(train_loader):
            data_timer.record()
            if current_iter >= total_iters:
                break
            current_iter += 1
            metrics = model.optimize_parameters(batch)
            iter_timer.record()

            if current_iter % print_freq == 0:
                metrics = model.reduce_metrics(metrics)  # the global batch's
                log_vars = {"epoch": epoch, "iter": current_iter,
                            "lrs": [model.current_lr(current_iter)],
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time()}
                log_vars.update({k: float(v) for k, v in metrics.items()})
                msg_logger(log_vars)
            if current_iter % save_freq == 0:
                logger.info("Saving models and training states.")
                model.save(current_iter)
            if val_freq and val_loader is not None and current_iter % val_freq == 0:
                _, improved = model.validation(device_prefetch(val_loader, device), current_iter,
                                               save_img=save_img)
                if improved:
                    model.save_best()
            data_timer.start()
            iter_timer.start()
        epoch += 1

    logger.info(f"End of training. Time consumed: {int(time.time() - start)}s")
    model.save(-1)  # latest
    if val_loader is not None and val_freq:
        model.validation(device_prefetch(val_loader, device), current_iter, save_img=save_img)
    return model


if __name__ == "__main__":
    try:
        train_pipeline(os.getcwd())
    finally:
        shutdown()
