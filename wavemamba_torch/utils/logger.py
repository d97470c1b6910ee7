"""Logging: windowed timers, formatted iteration logs with ETA, a file +
stream logger, optional TensorBoard, an environment banner. The counterpart
of `wavemamba_tpu/utils/logger.py`."""

from __future__ import annotations

import datetime
import logging
import time

initialized_loggers = set()


class AvgTimer:
    """Average time between `record()` calls over a window."""

    def __init__(self, window=200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """Formatted train-iteration log lines, and TensorBoard scalars."""

    def __init__(self, opt, start_iter=1, tb_logger=None):
        self.exp_name = opt["name"]
        self.interval = opt["logger"]["print_freq"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.use_tb_logger = opt["logger"].get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    def __call__(self, log_vars: dict):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch")
        lrs = log_vars.pop("lrs")
        message = f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        message += ", ".join(f"{v:.3e}" for v in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f} ({data_time:.3f})] "

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None and "debug" not in self.exp_name:
                label = f"losses/{k}" if k.startswith("l_") or k in ("l1", "fft", "total") else k
                self.tb_logger.add_scalar(label, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir):
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(log_dir=log_dir)


def get_root_logger(logger_name="wavemamba_torch", log_level=logging.INFO, log_file=None):
    """The package's logger: a stream handler, and a file handler when the
    first call names a `log_file`. Under a process group, as the JAX
    package's rule: rank 0 logs so, every other rank logs errors only and
    opens no file."""
    from wavemamba_torch.parallel.dist import get_dist_info

    logger = logging.getLogger(logger_name)
    if logger_name in initialized_loggers:
        return logger
    format_str = "%(asctime)s %(levelname)s: %(message)s"
    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(logging.Formatter(format_str))
    logger.addHandler(stream_handler)
    logger.propagate = False
    if get_dist_info()[0] != 0:
        logger.setLevel("ERROR")
        initialized_loggers.add(logger_name)
        return logger
    logger.setLevel(log_level)
    if log_file is not None:
        file_handler = logging.FileHandler(log_file, "w")
        file_handler.setFormatter(logging.Formatter(format_str))
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    initialized_loggers.add(logger_name)
    return logger


def get_env_info():
    import torch

    import wavemamba_torch

    cuda = torch.cuda.is_available()
    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else []
    return (f"\nwavemamba_torch {wavemamba_torch.__version__}"
            f"\n\ttorch: {torch.__version__}"
            f"\n\tcuda: {torch.version.cuda} (available: {cuda})"
            f"\n\tdevices: {cards}")


def init_wandb_logger(opt):
    """W&B in tensorboard-sync mode; raises where the wandb package is missing."""
    try:
        import wandb
    except ImportError as e:
        raise ImportError("wandb logging requires the 'wandb' package") from e
    logger = get_root_logger()
    project = opt["logger"]["wandb"]["project"]
    resume_id = opt["logger"]["wandb"].get("resume_id")
    if resume_id:
        wandb_id = resume_id
        resume = "allow"
        logger.warning(f"Resume wandb logger with id={wandb_id}.")
    else:
        wandb_id = wandb.util.generate_id()
        resume = "never"
    wandb.init(id=wandb_id, resume=resume, name=opt["name"], config=opt,
               project=project, sync_tensorboard=True)
    logger.info(f"Use wandb logger with id={wandb_id}; project={project}.")
