"""Training pipeline. The counterpart of `wavemamba_tpu/pipelines/train.py`.

    python -m wavemamba_torch.pipelines.train -opt options/train_wavemamba_uhdll.yml

One process drives one device: the card, or the CPU with `--device cpu` (the
only way onto it; without the flag a host without CUDA raises). The batch is
`batch_size_per_gpu`. Losses stay on the device; the host reads them at
`print_freq` only. Checkpoints are `.pth` and `.state` files
(`checkpoint.py`); `--auto_resume` continues from the highest saved state.
With `cache_on_device: true` the train set is staged on the device once
(`data/device_cache.py`) and its batches are drawn there.
"""

from __future__ import annotations

import os
import time

from wavemamba_torch.checkpoint import find_resume_state
from wavemamba_torch.data import (
    DeviceCachedLoader,
    EnlargedSampler,
    ThreadedLoader,
    build_dataset,
    device_prefetch,
)
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


def create_train_val_dataloader(opt, logger):
    train_loader, val_loader = None, None
    total_iters = int(opt["train"]["total_iter"])
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_set = build_dataset(dataset_opt)
            sampler = EnlargedSampler(len(train_set), 1, 0,
                                      dataset_opt.get("dataset_enlarge_ratio", 1))
            batch = dataset_opt.get("batch_size_per_gpu", 1)
            if dataset_opt.get("cache_on_device"):
                # The device-resident dataset (data/device_cache.py); a dataset
                # that does not qualify (shapes, mean/std, the budget) takes the
                # threaded host loader, as in the JAX package. Any other error
                # propagates.
                try:
                    train_loader = DeviceCachedLoader(
                        train_set, batch_size=batch, sampler=sampler, seed=opt.get("manual_seed"),
                        device=opt.get("device", "cuda"),
                        budget_gb=dataset_opt.get("device_cache_budget_gb", 8.0))
                    logger.info(f"cache_on_device: dataset staged on {train_loader.device} "
                                f"({train_loader.nbytes / 2**20:.0f} MiB); per-step host work is "
                                "index RNG only")
                except ValueError as e:
                    logger.warning(f"cache_on_device unavailable ({e}); using host loader")
            if train_loader is None:
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
            logger.info(f"Training statistics: images {len(train_set)}, batch {batch} (1 device), "
                        f"iters/epoch {iters_per_epoch}, total epochs {total_epochs}, "
                        f"total iters {total_iters}")
        elif phase.startswith("val"):
            val_set = build_dataset(dataset_opt)
            val_loader = ThreadedLoader(val_set, batch_size=1, num_workers=2)
            logger.info(f"Validation images: {len(val_set)}")
    return train_loader, val_loader, total_iters


def train_pipeline(root_path, args=None):
    opt, parsed = parse_options(root_path, is_train=True, args=args)
    set_random_seed(opt["manual_seed"])

    # An existing experiment directory is archived only on a fresh start; with
    # --auto_resume and a saved training state the run resumes in place.
    resuming = bool(opt.get("auto_resume")
                    and find_resume_state(opt["path"]["training_states"]) is not None)
    make_exp_dirs(opt, archive=not resuming)
    copy_opt_file(parsed.opt, opt["path"]["experiments_root"])
    log_file = os.path.join(opt["path"]["log"], f"train_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = None
    if opt.get("logger", {}).get("use_tb_logger") and "debug" not in opt["name"]:
        try:
            tb_logger = init_tb_logger(os.path.join(opt["path"]["log"], "tb_logger"))
        except Exception as e:
            logger.warning(f"tensorboard unavailable: {e}")

    train_loader, val_loader, total_iters = create_train_val_dataloader(opt, logger)
    model = build_model(opt)
    device = model.device

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
    train_pipeline(os.getcwd())
