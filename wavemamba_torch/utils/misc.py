"""Filesystem and seeding helpers. The counterpart of
`wavemamba_tpu/utils/misc.py`."""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch


def set_random_seed(seed: int):
    """Seed python's, numpy's and torch's global generators (the data
    pipeline's crops and flips draw from `random`)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str():
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str):
    """If path exists, archive it under a timestamp suffix; then mkdir."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict, archive: bool = True):
    """Create the experiment's (or the results') directory tree.

    archive=False leaves an existing root in place: used when resuming into
    an existing experiment."""
    path_opt = dict(opt["path"])
    root = path_opt.pop("experiments_root" if opt.get("is_train") else "results_root")
    if archive:
        mkdir_and_rename(root)
    else:
        os.makedirs(root, exist_ok=True)
    for key, path in path_opt.items():
        if ("strict_load" in key) or ("pretrain_network" in key) or ("resume" in key) or (
            "param_key" in key
        ):
            continue
        if isinstance(path, str):
            os.makedirs(path, exist_ok=True)


def scandir(dir_path, suffix=None, recursive=False, full_path=False):
    """Generator over the non-hidden file paths under `dir_path`."""
    if (suffix is not None) and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                return_path = entry.path if full_path else os.path.relpath(entry.path, root)
                if (suffix is None) or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix=suffix, recursive=recursive)

    return _scandir(dir_path, suffix=suffix, recursive=recursive)


def check_resume(opt: dict, resume_iter: int):
    """Point the pretrain paths at the weights saved with the resume state's
    iteration (`checkpoint.save_network` writes `net_<x>_<iter>.pth`)."""
    if not opt["path"].get("resume_state"):
        return
    networks = [k for k in opt.keys() if k.startswith("network_")]
    if any(opt["path"].get(f"pretrain_{n}") is not None for n in networks):
        print("pretrain_network path will be ignored during resuming.", flush=True)
    for network in networks:
        basename = network.replace("network_", "")
        if opt.get("ignore_resume_networks") is None or (
            network not in opt["ignore_resume_networks"]
        ):
            opt["path"][f"pretrain_{network}"] = os.path.join(
                opt["path"]["models"], f"net_{basename}_{resume_iter}.pth")


def sizeof_fmt(size, suffix="B"):
    for unit in ["", "K", "M", "G", "T", "P", "E", "Z"]:
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"
